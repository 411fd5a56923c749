"""Expert-parallel analogue: grouped convolution sharded over groups (the
counterpart of qnnpack_tpu/parallel/expert.py).

Each group of a grouped conv is an independent "expert" touching a
disjoint channel slice, so sharding the groups over a mesh axis needs no
collective: inputs, weights and outputs all split along channels.  Each
rank runs the ordinary quantized conv on a record of its groups
(nn/shard.py:channel_slice, built once per record), bit-identical to the
unsharded operator.
"""

from __future__ import annotations

from ..nn.conv import PackedConvWeights, q8conv2d
from ..nn.shard import channel_slice
from .mesh import axis_of


def grouped_conv2d_ep(x_u8, packed: PackedConvWeights, rparams, mesh,
                      axis: str = "model", strides=(1, 1),
                      padding=((0, 0), (0, 0)), dilation=(1, 1)):
    """Grouped quantized conv with groups sharded over `axis`.

    x_u8 is this rank's channel slice (groups // n groups of input
    channels, NHWC); the output is this rank's output channels.  Requires
    groups % n == 0."""
    n, index, _ = axis_of(mesh, axis)
    if packed.groups % n != 0:
        raise ValueError(f"groups={packed.groups} must divide over "
                         f"{n} shards")
    part = channel_slice(packed, n, index)
    return q8conv2d(x_u8, part.record, part.local_rparams(rparams),
                    strides=strides, padding=padding, dilation=dilation)
