"""q8conv: the dense and grouped conv kernel and its plain PyTorch version.

Port of qnnpack_tpu/kernels/q8conv.py:q8conv_pallas, extended to the
grouped convs (more than one channel per group) that the JAX package runs
in XLA (qnnpack_tpu/nn/conv.py:q8conv2d_acc); the CUDA source, with its
design and what bounds it, is csrc/q8conv.cu.  Depthwise convs belong to
q8dwconv.

`q8conv_cuda` takes the plain version for CPU tensors only.  For CUDA
tensors it launches the kernel or raises; there is no fallback.

`q8conv_partial_cuda` runs the kernel's partial instance on a dense conv:
the raw int32 sum_k A W' - kzp' * sum_k A over the record's taps and
channels (zero-point taps included), with no bias and no requantization,
which input-channel-sharded tensor parallelism sums across ranks
(parallel/mesh.py:conv_ic_tp).  Its launches count in its own `launches`.
"""

from __future__ import annotations

import torch

from ..nn.packing import K_STEP
from ..nn.requant_dispatch import apply_requant
from . import _build
from .q8gemm import gemm_acc_plain, partial_acc_plain, plan_launch


def check_conv(a_u8, packed) -> None:
    """Raise unless `packed` is a dense or grouped (not depthwise) conv over
    `a_u8`."""
    if (packed.groups > 1 and packed.group_input_channels == 1
            and packed.group_output_channels == 1):
        raise ValueError("a depthwise conv belongs to q8dwconv, not q8conv")
    channels = packed.groups * packed.group_input_channels
    if a_u8.dim() != 4 or a_u8.shape[3] != channels:
        raise ValueError(f"input {tuple(a_u8.shape)} does not match "
                         f"{channels} channels")


def conv_steps(packed):
    """(K steps of 64 bytes, deep) of a packed conv, as tile_plan takes
    them: a K step never straddles two taps, so 128-byte stages (`deep`)
    need each tap's padded channel run to hold whole ones."""
    _, taps, icpg_p = packed.w_kmajor.shape
    return taps * icpg_p // K_STEP, icpg_p % (2 * K_STEP) == 0


def q8conv_plain(a_u8, packed, rparams, strides=(1, 1),
                 padding=((0, 0), (0, 0)), dilation=(1, 1)):
    """Plain version of the kernel: uint8 NHWC -> uint8 NHWC.

    For each group g, the zero-point-padded im2col of its input channels
    [B*Ho*Wo, Kh*Kw*Icpg] times its weight columns g*Ocpg.. viewed as
    [K, Ocpg]: exact, since the folded bias counts Kh*Kw*Icpg = K taps of
    za'*zw' and the im2col row sum is the group's window sum of the padded
    input.  The groups' accumulators are concatenated along channels and
    requantized once."""
    from ..nn.conv import im2col  # nn.conv imports this module
    check_conv(a_u8, packed)
    icpg, ocpg = packed.group_input_channels, packed.group_output_channels
    k = packed.kernel_height * packed.kernel_width * icpg
    accs = []
    for g in range(packed.groups):
        cols, (b, ho, wo) = im2col(a_u8[..., g * icpg:(g + 1) * icpg],
                                   packed, strides, padding, dilation)
        cout = slice(g * ocpg, (g + 1) * ocpg)
        accs.append(gemm_acc_plain(cols, packed.w[..., cout].reshape(k, ocpg),
                                   packed.bias_folded[cout],
                                   packed.kzp_biased))
    acc = torch.cat(accs, dim=-1)
    return apply_requant(acc, rparams).reshape(b, ho, wo, -1)


def q8conv_partial_plain(a_u8, packed, strides=(1, 1),
                         padding=((0, 0), (0, 0)), dilation=(1, 1)):
    """Plain version of the partial instance: int32 NHWC, the
    zero-point-padded im2col times the weights viewed as [K, O] through
    q8gemm's partial_acc_plain (its row sums count the izp taps)."""
    from ..nn.conv import im2col  # nn.conv imports this module
    _check_partial(a_u8, packed)
    cols, (b, ho, wo) = im2col(a_u8, packed, strides, padding, dilation)
    k = cols.shape[1]
    acc = partial_acc_plain(cols, packed.w.reshape(k, -1),
                            packed.kzp_biased)
    return acc.reshape(b, ho, wo, -1)


def _check_partial(a_u8, packed) -> None:
    check_conv(a_u8, packed)
    if packed.groups != 1:
        raise ValueError("the partial instance runs dense convs (groups 1)")


def _check_launch(a_u8, packed):
    """Raise unless the launch's operands are CUDA tensors that fit;
    returns (o, taps, icpg_p) of the K-major weights."""
    _build.check_cuda("a", a_u8, torch.uint8, 4)
    _build.check_cuda("w_kmajor", packed.w_kmajor, torch.int8, 3)
    _build.check_cuda("bias_c", packed.bias_c, torch.int32, 1)
    if packed.w_kmajor.device != a_u8.device:
        raise ValueError(f"weights on {packed.w_kmajor.device}, activations "
                         f"on {a_u8.device}")
    kh, kw = packed.kernel_height, packed.kernel_width
    o, taps, icpg_p = packed.w_kmajor.shape
    if (taps != kh * kw or icpg_p % K_STEP
            or icpg_p < packed.group_input_channels):
        raise ValueError(f"w_kmajor shape {(o, taps, icpg_p)} does not fit "
                         f"{kh}x{kw} taps of {packed.group_input_channels} "
                         "channels")
    return o, taps, icpg_p


def q8conv_partial_cuda(a_u8, packed, strides=(1, 1),
                        padding=((0, 0), (0, 0)), dilation=(1, 1)):
    """The partial instance: uint8 NHWC -> int32 NHWC [B, Ho, Wo, O] of a
    dense conv (see q8conv_partial_plain)."""
    _check_partial(a_u8, packed)
    if a_u8.device.type == "cpu":
        return q8conv_partial_plain(a_u8, packed, strides, padding,
                                    dilation)
    o, _, icpg_p = _check_launch(a_u8, packed)
    b, h, w, c = a_u8.shape
    kh, kw = packed.kernel_height, packed.kernel_width
    ho, wo = _build.out_dims(h, w, kh, kw, strides, padding, dilation)
    out = torch.empty((b, ho, wo, o), dtype=torch.int32, device=a_u8.device)
    steps, deep = conv_steps(packed)
    stream = _build.stream_of(a_u8)
    work, plan = plan_launch(a_u8.device, stream, b * ho * wo, o, steps, 1,
                             deep)
    _build.launch(
        "qnn_q8conv_partial", a_u8.device.index or 0, a_u8.data_ptr(),
        packed.w_kmajor.data_ptr(), out.data_ptr(), b, h, w, c, ho, wo, o,
        1, kh, kw, strides[0], strides[1], padding[0][0], padding[1][0],
        dilation[0], dilation[1], packed.input_zero_point, packed.kzp_biased,
        icpg_p, *plan, stream)
    q8conv_partial_cuda.launches += 1
    return out


q8conv_partial_cuda.launches = 0


def q8conv_cuda(a_u8, packed, rparams, strides=(1, 1),
                padding=((0, 0), (0, 0)), dilation=(1, 1)):
    """Quantized dense or grouped conv: uint8 NHWC -> uint8 NHWC (any
    requant scheme).

    `packed` is an nn.conv.PackedConvWeights that is not depthwise."""
    check_conv(a_u8, packed)
    if a_u8.device.type == "cpu":
        return q8conv_plain(a_u8, packed, rparams, strides, padding,
                            dilation)
    o, _, icpg_p = _check_launch(a_u8, packed)
    b, h, w, c = a_u8.shape
    kh, kw = packed.kernel_height, packed.kernel_width
    ho, wo = _build.out_dims(h, w, kh, kw, strides, padding, dilation)
    scales, rq = _build.requant_args(rparams, o, a_u8.device)
    out = torch.empty((b, ho, wo, o), dtype=torch.uint8, device=a_u8.device)
    steps, deep = conv_steps(packed)
    stream = _build.stream_of(a_u8)
    work, plan = plan_launch(a_u8.device, stream, b * ho * wo,
                             packed.group_output_channels, steps,
                             packed.groups, deep)
    _build.launch(
        "qnn_q8conv", a_u8.device.index or 0, a_u8.data_ptr(),
        packed.w_kmajor.data_ptr(), packed.bias_c.data_ptr(),
        None if scales is None else scales.data_ptr(), out.data_ptr(),
        b, h, w, c, ho, wo, o, packed.groups, kh, kw, strides[0],
        strides[1], padding[0][0], padding[1][0], dilation[0], dilation[1],
        packed.input_zero_point, packed.kzp_biased, icpg_p, *plan, *rq,
        stream)
    q8conv_cuda.launches += 1
    return out


q8conv_cuda.launches = 0
