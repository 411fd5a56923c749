"""Operator lifecycle API: the port of qnnpack_tpu/ops (include/qnnpack.h).

One class per reference operator (create-call parity cited in each class):

    Convolution2D        qnnp_create_convolution2d_nhwc_q8
    Deconvolution2D      qnnp_create_deconvolution2d_nhwc_q8
    FullyConnected       qnnp_create_fully_connected_nc_q8
    MaxPooling2D         qnnp_create_max_pooling2d_nhwc_u8
    AveragePooling2D     qnnp_create_average_pooling2d_nhwc_q8
    GlobalAveragePooling qnnp_create_global_average_pooling_nwc_q8
    Add                  qnnp_create_add_nc_q8
    Clamp                qnnp_create_clamp_nc_u8
    Sigmoid              qnnp_create_sigmoid_nc_q8
    LeakyReLU            qnnp_create_leaky_relu_nc_q8
    SoftArgMax           qnnp_create_softargmax_nc_q8
    ChannelShuffle       qnnp_create_channel_shuffle_nc_x8

Construction == create (+ validation, packed weights and tables on the
device; the GPU unless device="cpu"), call == run, `.delete()` == delete.
"""

from .base import Operator  # noqa: F401
from .convolution import Convolution2D, Deconvolution2D  # noqa: F401
from .elementwise import (  # noqa: F401
    Add, ChannelShuffle, Clamp, LeakyReLU, Sigmoid, SoftArgMax,
)
from .fully_connected import FullyConnected  # noqa: F401
from .pooling import (  # noqa: F401
    AveragePooling2D, GlobalAveragePooling, MaxPooling2D,
)
