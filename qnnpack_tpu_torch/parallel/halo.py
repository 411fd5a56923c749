"""Spatial (sequence-parallel analogue) sharding: conv over sharded H, the
counterpart of qnnpack_tpu/parallel/halo.py.

Each rank of a mesh axis owns a contiguous band of input rows and borrows
`pad_top` rows from the rank above and `pad_bottom` rows from the rank
below before convolving.  The rows move with torch.distributed point to
point, both directions in one dist.batch_isend_irecv so that no rank waits
on another's send; the edge ranks fill with the input zero point, exactly
the unsharded conv's zero-point padding, so the sharded conv is
bit-identical to nn.conv.q8conv2d (nothing is summed across ranks).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..nn.conv import q8conv2d
from ..nn.shard import check_device
from .mesh import axis_of


def _exchange(x_local, pt: int, pb: int, index: int, n: int, group,
              fill: int):
    """(rows from above, rows from below): the last pt rows of rank
    index - 1 and the first pb rows of rank index + 1 along the group,
    `fill` bytes at the edges."""
    ranks = dist.get_process_group_ranks(group)
    shape = list(x_local.shape)
    prev = next_ = None
    ops = []
    if pt > 0:
        prev = torch.full(shape[:1] + [pt] + shape[2:], fill,
                          dtype=x_local.dtype, device=x_local.device)
        if index < n - 1:
            ops.append(dist.P2POp(dist.isend, x_local[:, -pt:].contiguous(),
                                  ranks[index + 1], group))
        if index > 0:
            ops.append(dist.P2POp(dist.irecv, prev, ranks[index - 1], group))
    if pb > 0:
        next_ = torch.full(shape[:1] + [pb] + shape[2:], fill,
                           dtype=x_local.dtype, device=x_local.device)
        if index > 0:
            ops.append(dist.P2POp(dist.isend, x_local[:, :pb].contiguous(),
                                  ranks[index - 1], group))
        if index < n - 1:
            ops.append(dist.P2POp(dist.irecv, next_, ranks[index + 1],
                                  group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return prev, next_


def spatial_conv2d(x_u8, packed, rparams, mesh, axis: str = "data",
                   strides=(1, 1), padding=((0, 0), (0, 0)),
                   dilation=(1, 1)):
    """Quantized conv with the input H dimension sharded over `axis`.

    x_u8 is this rank's band of rows [B, H/n, W, C]; the output is this
    rank's band of output rows.  Bit-identical to the unsharded
    nn.conv.q8conv2d under the even-output-split geometry:

        pad_top + pad_bottom == (kh - 1) * dh + 1 - stride_h   (ho == h/sh)
        h % (n_shards * stride_h) == 0

    which covers the "SAME"-style convs CNN backbones use."""
    n, index, group = axis_of(mesh, axis)
    b, hs, w, c = x_u8.shape
    h = hs * n
    sh, _ = strides
    (pt, pb), pad_w = padding
    kh = packed.kernel_height
    dh, _ = dilation
    eff_h = (kh - 1) * dh + 1
    if pt + pb != eff_h - sh:
        raise ValueError(
            f"spatial_conv2d needs pad_top+pad_bottom == {eff_h - sh} "
            f"(even output split), got {pt}+{pb}")
    if h % (n * sh) != 0:
        raise ValueError(
            f"H={h} must divide into {n} shards of a multiple of stride {sh}")
    if max(pt, pb) > hs:
        raise ValueError(f"halo {max(pt, pb)} exceeds shard height {hs}")
    check_device(x_u8, mesh.device_type, "halo exchange")
    prev, next_ = _exchange(x_u8, pt, pb, index, n, group,
                            packed.input_zero_point)
    parts = [t for t in (prev, x_u8, next_) if t is not None]
    x_ext = torch.cat(parts, dim=1) if len(parts) > 1 else x_u8
    return q8conv2d(x_ext, packed, rparams, strides=strides,
                    padding=((0, 0), pad_w), dilation=dilation)
