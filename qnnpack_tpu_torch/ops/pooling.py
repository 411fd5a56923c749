"""Pooling operators: MaxPooling2D, AveragePooling2D, GlobalAveragePooling -
a port of qnnpack_tpu/ops/pooling.py.

Lifecycle and validation parity with src/max-pooling.c,
src/average-pooling.c and src/global-average-pooling.c: the same messages
and exception types as the JAX package.  On the GPU: MaxPooling2D runs the
u8maxpool kernel with the output range as its fused clamp (one launch,
ranged or not), AveragePooling2D q8avgpool and GlobalAveragePooling
q8gavgpool.
"""

from __future__ import annotations

from ..kernels.pool import u8maxpool_cuda
from ..nn.pool import q8avgpool2d, q8gavgpool
from ..quant.params import compute_avgpool_quant_params
from .base import (Operator, check, check_range, check_scale,
                   check_supported, check_zero_point)


class MaxPooling2D(Operator):
    """qnnp_create_max_pooling2d_nhwc_u8 (include/qnnpack.h:192-218;
    src/max-pooling.c:36-135)."""

    name = "max_pooling2d"

    def __init__(self, *, pool_size, strides=None, padding=((0, 0), (0, 0)),
                 dilation=(1, 1), output_min=0, output_max=255,
                 device="cuda"):
        ph, pw = pool_size
        check(ph * pw > 0, f"failed to create max pooling with {pw}x{ph} "
              f"pooling size: pooling size dimensions must be non-zero")
        check(ph * pw > 1, f"failed to create max pooling with 1 pooling "
              f"element: 1x1 pooling is meaningless (max-pooling.c:72-77)")
        strides = strides if strides is not None else (ph, pw)
        check(strides[0] > 0 and strides[1] > 0,
              "stride dimensions must be non-zero")
        check(dilation[0] > 0 and dilation[1] > 0,
              "dilation dimensions must be non-zero")
        check_range(output_min, output_max)
        super().__init__(device)
        self.pool_size = (int(ph), int(pw))
        self.strides = tuple(int(s) for s in strides)
        self.padding = tuple((int(a), int(b)) for a, b in padding)
        self.dilation = tuple(int(d) for d in dilation)
        self.output_min = int(output_min)
        self.output_max = int(output_max)

    def _forward(self, x):
        return u8maxpool_cuda(x.contiguous(), self.pool_size, self.strides,
                              self.padding, self.dilation, self.output_min,
                              self.output_max)


class AveragePooling2D(Operator):
    """qnnp_create_average_pooling2d_nhwc_q8 (include/qnnpack.h:162-190;
    src/average-pooling.c:34-190)."""

    name = "average_pooling2d"

    def __init__(self, *, pool_size, input_zero_point, input_scale,
                 output_zero_point, output_scale, strides=None,
                 padding=((0, 0), (0, 0)), output_min=0, output_max=255,
                 device="cuda"):
        ph, pw = pool_size
        check(ph * pw > 0, "pooling size dimensions must be non-zero")
        check(ph * pw > 1, "1x1 average pooling is meaningless")
        strides = strides if strides is not None else (ph, pw)
        check(strides[0] > 0 and strides[1] > 0,
              "stride dimensions must be non-zero")
        check_scale(input_scale, "input")
        check_scale(output_scale, "output")
        check_zero_point(input_zero_point, "input")
        check_zero_point(output_zero_point, "output")
        check_range(output_min, output_max)
        ratio = float(input_scale) / float(output_scale)
        check_supported(2.0**-8 <= ratio < 2.0**8,
                        f"failed to create average pooling with {ratio:.7f} "
                        f"input-to-output scale ratio: ratio must be in "
                        f"[2**-8, 2**8) range (average-pooling.c:113-120)")
        pooling_size = ph * pw
        check_supported(pooling_size < 16777216,
                        "pooling size must be below 2**24 "
                        f"(average-pooling.c:122-126), got {pooling_size}")
        super().__init__(device)
        self.pool_size = (int(ph), int(pw))
        self.strides = tuple(int(s) for s in strides)
        self.padding = tuple((int(a), int(b)) for a, b in padding)
        # bias = -izp * pooling_size: the net accumulator of the reference's
        # zero-buffer + multipass-row algebra (nn/pool.py:q8avgpool2d).
        self.qparams = compute_avgpool_quant_params(
            -int(input_zero_point) * pooling_size,
            float(input_scale) / (float(output_scale) * pooling_size),
            output_zero_point, output_min, output_max,
            input_zero_point=int(input_zero_point))

    def _forward(self, x):
        return q8avgpool2d(x.contiguous(), self.qparams, self.pool_size,
                           self.strides, self.padding)


class GlobalAveragePooling(Operator):
    """qnnp_create_global_average_pooling_nwc_q8 (include/qnnpack.h:142-160;
    src/global-average-pooling.c:22-105).  Input [batch, width, channels];
    the reduction width binds at the first call with it, its params cached
    per width (the reference binds it at setup,
    global-average-pooling.c:132-141)."""

    name = "global_average_pooling"

    def __init__(self, *, channels, input_zero_point, input_scale,
                 output_zero_point, output_scale, output_min=0,
                 output_max=255, device="cuda"):
        check(channels > 0, "number of channels must be non-zero")
        check_scale(input_scale, "input")
        check_scale(output_scale, "output")
        check_zero_point(input_zero_point, "input")
        check_zero_point(output_zero_point, "output")
        check_range(output_min, output_max)
        ratio = float(input_scale) / float(output_scale)
        check_supported(2.0**-8 <= ratio < 2.0**8,
                        f"failed to create global average pooling with "
                        f"{ratio:.7g} input-to-output scale ratio: ratio must "
                        f"be in [2**-8, 2**8) range "
                        f"(global-average-pooling.c:63-69)")
        super().__init__(device)
        self.channels = int(channels)
        self.input_zero_point = int(input_zero_point)
        self.input_scale = float(input_scale)
        self.output_zero_point = int(output_zero_point)
        self.output_scale = float(output_scale)
        self.output_min = int(output_min)
        self.output_max = int(output_max)
        self._width_cache = {}

    def _params_for_width(self, width: int):
        if width not in self._width_cache:
            self._width_cache[width] = compute_avgpool_quant_params(
                -width * self.input_zero_point,
                self.input_scale / (self.output_scale * width),
                self.output_zero_point, self.output_min, self.output_max,
                input_zero_point=self.input_zero_point)
        return self._width_cache[width]

    def _forward(self, x):
        check(x.shape[-1] == self.channels,
              f"input has {x.shape[-1]} channels, operator created with "
              f"{self.channels}")
        width = x.shape[1]
        check(width > 0, "width must be non-zero")
        return q8gavgpool(x, self._params_for_width(width), axis=1)
