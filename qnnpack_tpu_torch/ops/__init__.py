"""Operator lifecycle API: the port of qnnpack_tpu/ops (include/qnnpack.h).

One class per reference operator (create-call parity cited in each class):

    Add                  qnnp_create_add_nc_q8
    Clamp                qnnp_create_clamp_nc_u8
    Sigmoid              qnnp_create_sigmoid_nc_q8
    LeakyReLU            qnnp_create_leaky_relu_nc_q8
    SoftArgMax           qnnp_create_softargmax_nc_q8
    ChannelShuffle       qnnp_create_channel_shuffle_nc_x8

Construction == create (+ validation, tables on the device; the GPU unless
device="cpu"), call == run, `.delete()` == delete.  Still to port (ROADMAP
Queue 1 item 10): Convolution2D, Deconvolution2D, FullyConnected,
MaxPooling2D, AveragePooling2D and GlobalAveragePooling.
"""

from .base import Operator  # noqa: F401
from .elementwise import (  # noqa: F401
    Add, ChannelShuffle, Clamp, LeakyReLU, Sigmoid, SoftArgMax,
)
