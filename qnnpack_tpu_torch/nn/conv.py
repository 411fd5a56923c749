"""Quantized convolution: dense, grouped and depthwise.

Zero-point algebra as in qnnpack_tpu/nn/conv.py: the input is padded with
the input zero point, so a padded tap adds exactly zero to
sum (a - za)(w - zw), like QNNPACK's zero buffer (src/convolution.c:330-339).

  - Depthwise (groups == channels, one channel per group) runs the q8dwconv
    kernel, which reads the window straight from NHWC.
  - Grouped (groups > 1, more than one channel per group) runs the q8conv
    kernel, one implicit GEMM per group.  The JAX package's split, einsum
    and feature_group_count lowerings are TPU forms of the same sums and
    are not carried over.
  - Dense (groups == 1) routes by `dense_conv_route`: the stem class
    (stride 2, C_in <= 4, kzp 128) to the q8stem kernel, every other dense
    conv to the q8conv kernel.  The plain version of both kernels is the
    zero-point-padded `im2col` (K ordered [kh, kw, cin] as the pack lays W
    out) times the packed weights viewed as [K, N], group by group.

  - Transposed (q8deconv2d) lowers onto the same kernels, with JAX's
    three lowerings (qnnpack_tpu/nn/conv.py:q8deconv2d, _deconv_phase):
    k == s unpadded is one q8gemm (or grouped 1x1 q8conv) launch to
    phase-major channels and a depth-to-space copy; any other strided,
    undilated deconv is one stride-1 launch a sub-pixel phase and an
    interleaving copy; stride 1 or dilation > 1 is one launch over the
    input dilated with its zero point.  The derived records (`DeconvPlan`)
    are built once per record and geometry, so a forward only launches.

Kernel layout: O x Kh x Kw x Icpg (uint8), QNNPACK's NHWC operator
convention.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels.q8conv import q8conv_cuda, q8conv_partial_cuda
from ..kernels.q8dwconv import q8dwconv_cuda
from ..kernels.q8stem import MAX_INPUT_CHANNELS, q8stem_cuda
from .dtypes import biased_zero_point, u8_to_biased_i8
from .gemm import q8gemm
from .packing import (PackedGemmWeights, as_tensor, fold_bias, round_up,
                      set_kernel_fields, wrap_int32)
from .requant_dispatch import apply_requant
from .shard import ColumnShard

# The q8stem kernel's K order pads each kernel row to a multiple of this
# many bytes (two rows of a 3- or 7-wide RGB window fill one 64-byte step).
STEM_ROW_STEP = 32


@dataclasses.dataclass(frozen=True)
class PackedConvWeights:
    """Conv weights in HWIO int8 layout with folded bias.

    w:           int8 [Kh, Kw, Icpg, O] biased (value - 128), contiguous
    bias_folded: int32 [O]
    w_kmajor:    int8 [O, Kh*Kw, Icpg_p] w regrouped K-major, each tap's
                 channel run zero-padded to Icpg_p = Icpg rounded up to the
                 kernels' 64-byte K step (derived; nn/packing.py)
    bias_c:      int32 [O] kmajor_bias of bias_folded, K = Kh*Kw*Icpg
                 (derived)
    w_dw:        float32 [Kh*Kw, C] W' - kzp', the q8dwconv kernel's
                 weights, on a record with one channel per group (a
                 one-channel record of groups 1 too); None otherwise
                 (derived)
    w_stem:      int8 [O, Kh*Rs] of a record that can be a stem (groups 1,
                 Icpg <= 4): kernel row ky's Kw*Icpg bytes in [kx, c] order
                 at ky*Rs, zero up to Rs = Kw*Icpg rounded up to
                 STEM_ROW_STEP, the q8stem kernel's K order; None otherwise
                 (derived)
    deconv_plans: the DeconvPlan of each geometry this record has run a
                 deconv at, built on first use (q8deconv2d); empty at
                 construction
    tp_slices:   the tensor-parallel slices of this record built so far
                 (nn/shard.py, parallel/); empty at construction
    """

    w: torch.Tensor
    bias_folded: torch.Tensor
    kernel_height: int
    kernel_width: int
    group_input_channels: int
    group_output_channels: int
    groups: int
    input_zero_point: int
    kernel_zero_point: int
    w_kmajor: torch.Tensor = dataclasses.field(init=False, repr=False,
                                               compare=False)
    bias_c: torch.Tensor = dataclasses.field(init=False, repr=False,
                                             compare=False)
    w_dw: torch.Tensor | None = dataclasses.field(init=False, repr=False,
                                                  compare=False)
    w_stem: torch.Tensor | None = dataclasses.field(init=False, repr=False,
                                                    compare=False)
    deconv_plans: dict = dataclasses.field(init=False, repr=False,
                                           compare=False)
    tp_slices: dict = dataclasses.field(init=False, repr=False,
                                        compare=False)

    def __post_init__(self):
        kh, kw, icpg, o = self.w.shape
        wk = torch.zeros((o, kh * kw, round_up(icpg)), dtype=torch.int8,
                         device=self.w.device)
        wk[..., :icpg] = self.w.permute(3, 0, 1, 2).reshape(o, kh * kw, icpg)
        set_kernel_fields(self, wk,
                          self.w.to(torch.int64).sum(dim=(0, 1, 2)),
                          kh * kw * icpg)
        w_dw = w_stem = None
        if icpg == 1 and self.group_output_channels == 1:
            w_dw = (self.w.reshape(kh * kw, o).to(torch.float32)
                    - self.kzp_biased)
        if self.groups == 1 and icpg <= MAX_INPUT_CHANNELS:
            rs = round_up(kw * icpg, STEM_ROW_STEP)
            w_stem = torch.zeros((o, kh, rs), dtype=torch.int8,
                                 device=self.w.device)
            w_stem[..., :kw * icpg] = self.w.permute(3, 0, 1, 2).reshape(
                o, kh, kw * icpg)
            w_stem = w_stem.reshape(o, kh * rs)
        object.__setattr__(self, "w_dw", w_dw)
        object.__setattr__(self, "w_stem", w_stem)
        object.__setattr__(self, "deconv_plans", {})
        object.__setattr__(self, "tp_slices", {})

    @property
    def izp_biased(self) -> int:
        return biased_zero_point(self.input_zero_point)

    @property
    def kzp_biased(self) -> int:
        return biased_zero_point(self.kernel_zero_point)

    def as_gemm(self) -> PackedGemmWeights:
        """The dense (groups = 1) weights as GEMM weights [Kh*Kw*Icpg, O]."""
        k = self.kernel_height * self.kernel_width * self.group_input_channels
        return PackedGemmWeights(
            w=self.w.reshape(k, -1), bias_folded=self.bias_folded, k=k,
            n=self.w.shape[-1], input_zero_point=self.input_zero_point,
            kernel_zero_point=self.kernel_zero_point)


def pack_conv_weights(kernel, bias, input_zero_point: int,
                      kernel_zero_point: int, groups: int = 1,
                      transposed: bool = False, *,
                      device=None) -> PackedConvWeights:
    """Pack conv/deconv weights (pack_q8conv_w / pack_q8deconv_w analogue,
    pack.h:51-133).

    kernel: uint8 [O, Kh, Kw, Icpg] with O = groups * group_output_channels.
    For `transposed` (deconvolution) the kernel is flipped spatially, as
    the JAX package packs it; the folded bias, a sum over every tap, is
    the same either way.  A record that is already flipped (one from the
    JAX package or a checkpoint) is not packed again.  Recorded as one
    span setup.pack (utils/profiling.py).
    """
    from ..utils import profiling
    with profiling.span("setup.pack"):
        kernel = as_tensor(kernel, torch.uint8, device)
        o, kh, kw, icpg = kernel.shape
        if o % groups:
            raise ValueError("output channels must divide evenly into groups")
        if bias is None:
            bias = torch.zeros((o,), dtype=torch.int32, device=kernel.device)
        bias = as_tensor(bias, torch.int32, kernel.device)

        w = u8_to_biased_i8(kernel)  # [O, Kh, Kw, Icpg]
        w_sums = w.to(torch.int64).sum(dim=(1, 2, 3))  # [O]
        bias_folded = fold_bias(bias, w_sums, kh * kw * icpg,
                                input_zero_point, kernel_zero_point)
        if transposed:
            w = w.flip(1, 2)
        return PackedConvWeights(
            w=w.permute(1, 2, 3, 0).contiguous(), bias_folded=bias_folded,
            kernel_height=int(kh), kernel_width=int(kw),
            group_input_channels=int(icpg),
            group_output_channels=int(o // groups), groups=int(groups),
            input_zero_point=int(input_zero_point),
            kernel_zero_point=int(kernel_zero_point))


def _pad_input(a_u8, padding, value: int):
    """Pad uint8 NHWC spatially with a constant (the input zero point)."""
    (pt, pb), (pl_, pr) = padding
    if pt == pb == pl_ == pr == 0:
        return a_u8
    return F.pad(a_u8, (0, 0, pl_, pr, pt, pb), value=value)


def im2col(a_u8, packed: PackedConvWeights, strides=(1, 1),
           padding=((0, 0), (0, 0)), dilation=(1, 1)):
    """Zero-point-padded patches [B*Ho*Wo, Kh*Kw*C], K ordered [kh, kw, c]."""
    a = _pad_input(a_u8, padding, packed.input_zero_point)
    b, hp, wp, c = a.shape
    kh, kw = packed.kernel_height, packed.kernel_width
    (sh, sw), (dh, dw) = strides, dilation
    ho = (hp - ((kh - 1) * dh + 1)) // sh + 1
    wo = (wp - ((kw - 1) * dw + 1)) // sw + 1
    taps = [a[:, ky * dh:ky * dh + (ho - 1) * sh + 1:sh,
              kx * dw:kx * dw + (wo - 1) * sw + 1:sw, :]
            for ky in range(kh) for kx in range(kw)]
    return torch.stack(taps, dim=3).reshape(b * ho * wo, kh * kw * c), \
        (b, ho, wo)


def dense_conv_route(packed: PackedConvWeights, strides,
                     dilation=(1, 1)) -> str:
    """Kernel of a dense (groups = 1) conv: "q8stem" or "q8conv".

    The JAX package's stem rule (qnnpack_tpu/nn/conv.py:
    _route_stem_pallas) without its backend and tuning gates: stride
    (2, 2), no dilation, a window of more than one tap, kzp == 128 and at
    most 4 input channels go to the stem kernel."""
    if (packed.groups == 1 and tuple(strides) == (2, 2)
            and tuple(dilation) == (1, 1)
            and packed.kernel_height * packed.kernel_width > 1
            and packed.kzp_biased == 0
            and packed.group_input_channels <= MAX_INPUT_CHANNELS):
        return "q8stem"
    return "q8conv"


def q8conv2d(a_u8, packed: PackedConvWeights, rparams, strides=(1, 1),
             padding=((0, 0), (0, 0)), dilation=(1, 1)):
    """Quantized 2D convolution: uint8 NHWC -> uint8 NHWC.

    Depthwise convs run q8dwconv, grouped ones q8conv, dense ones the
    kernel `dense_conv_route` names.  A ColumnShard (parallel.shard_params)
    runs its rank's output channels (and its groups' input channels) and
    gathers every rank's."""
    strides, dilation = tuple(strides), tuple(dilation)
    if isinstance(packed, ColumnShard):
        return packed.run(q8conv2d, a_u8, rparams, strides, padding,
                          dilation)
    if (packed.groups > 1 and packed.group_input_channels == 1
            and packed.group_output_channels == 1):
        return q8dwconv_cuda(a_u8, packed, rparams, strides, padding,
                             dilation)
    if dense_conv_route(packed, strides, dilation) == "q8stem":
        return q8stem_cuda(a_u8, packed, rparams, padding)
    return q8conv_cuda(a_u8, packed, rparams, strides, padding, dilation)


def q8conv2d_partial(a_u8, packed: PackedConvWeights, strides=(1, 1),
                     padding=((0, 0), (0, 0)), dilation=(1, 1)):
    """The int32 partial of a dense conv over the record's input channels:
    NHWC [B, Ho, Wo, O] of sum A W' - kzp' * sum A over the
    zero-point-padded taps, with no bias and no requantization (q8conv's
    partial instance; never q8stem, since an input-channel slice of a stem
    is not a stem).  Input-channel slices' partials, summed in int32, plus
    the full record's bias_c, requantized by nn.gemm.q8requant, are
    q8conv2d (parallel/mesh.py:conv_ic_tp)."""
    return q8conv_partial_cuda(a_u8, packed, tuple(strides), padding,
                               tuple(dilation))


# ------------------------------------------------------------ deconvolution
def deconv_output_dims(input_size: int, padding_total: int, adjustment: int,
                       kernel: int, dilation: int, stride: int) -> int:
    """Transposed-conv output size (deconvolution.c:26-36)."""
    effective = (kernel - 1) * dilation + 1
    return stride * (input_size - 1) + adjustment + effective - padding_total


def _dilated_pads(packed: PackedConvWeights, padding, adjustment, dilation):
    """(top, bottom, left, right) padding of the lhs-dilated conv that
    realizes the transposed conv's geometry."""
    eff_h = (packed.kernel_height - 1) * dilation[0] + 1
    eff_w = (packed.kernel_width - 1) * dilation[1] + 1
    (pt, pb), (pl_, pr) = padding
    return (eff_h - 1 - pt, eff_h - 1 - pb + adjustment[0],
            eff_w - 1 - pl_, eff_w - 1 - pr + adjustment[1])


def deconv_lowering(packed: PackedConvWeights, strides=(1, 1),
                    padding=((0, 0), (0, 0)), adjustment=(0, 0),
                    dilation=(1, 1)) -> str:
    """Which of JAX's three lowerings runs a deconv (qnnpack_tpu/nn/
    conv.py:372, :465-467): "k_eq_s" (kernel == stride, no padding or
    adjustment), "phase" (any other strided, undilated deconv), "dilated"
    (stride 1, or dilation > 1), or "unsupported" (the dilated lowering
    with a padding larger than the effective kernel)."""
    if tuple(dilation) == (1, 1) and max(strides) > 1:
        (pt, pb), (pl_, pr) = padding
        if ((packed.kernel_height, packed.kernel_width) == tuple(strides)
                and pt == pb == pl_ == pr == 0
                and tuple(adjustment) == (0, 0)):
            return "k_eq_s"
        return "phase"
    if min(_dilated_pads(packed, padding, adjustment, dilation)) < 0:
        return "unsupported"
    return "dilated"


@dataclasses.dataclass(frozen=True)
class DeconvPhase:
    """One sub-pixel phase (r, q) of a strided deconv: output rows r::sy
    and columns q::sx.  `record` is its stride-1 sub-kernel (taps in
    reverse order, the missing taps' constants folded into its bias), or
    None for a phase no tap reaches, whose every output is `const`, a
    uint8 [O] row.  j0u / j0v and tu / tv locate its input window
    (qnnpack_tpu/nn/conv.py:524-529)."""

    r: int
    q: int
    j0u: int
    j0v: int
    tu: int
    tv: int
    record: PackedConvWeights | None
    const: torch.Tensor | None


@dataclasses.dataclass(frozen=True)
class DeconvPlan:
    """What a deconv of one record at one geometry launches, derived once
    (deconv_plan):
      - "k_eq_s": `record`, the phase-major weights W2 [Icpg, g*sy*sx*Og]
        as GEMM weights (groups 1) or a grouped 1x1 conv record;
      - "phase": `phases`, one DeconvPhase each;
      - "dilated": `pads`, the lhs-dilated conv's padding (the record
        itself is launched)."""

    lowering: str
    strides: tuple
    padding: tuple
    adjustment: tuple
    dilation: tuple
    record: object = None
    phases: tuple = ()
    pads: tuple = ()


def _k_eq_s_record(packed: PackedConvWeights, w_orig, w_all):
    """The record of the k == s lowering (qnnpack_tpu/nn/conv.py:475-503):
    every output position takes one tap, so the deconv is one 1x1 product
    to g*sy*sx*Og phase-major channels.  Its bias folds the missing taps'
    za' * (sum_all - sum_phase) W' and -zw' * za' * (Kh*Kw - 1) * Icpg;
    the kernel's own -kzp' * sum A' over the one tap is JAX's window sum
    `ch`, so the record keeps the layer's zero points."""
    kh, kw = packed.kernel_height, packed.kernel_width
    icpg, og, g = (packed.group_input_channels, packed.group_output_channels,
                   packed.groups)
    za, zw = packed.izp_biased, packed.kzp_biased
    w2 = w_orig.reshape(kh, kw, icpg, g, og).permute(3, 0, 1, 4, 2)
    w2 = w2.reshape(g, kh * kw * og, icpg).permute(2, 0, 1).reshape(
        icpg, g * kh * kw * og).contiguous()
    w64 = w_orig.to(torch.int64)
    w_phase = w64.reshape(kh * kw, icpg, g, og).sum(dim=1)
    w_phase = w_phase.permute(1, 0, 2).reshape(-1)
    w_all_t = w_all.reshape(g, og).repeat_interleave(kh * kw, dim=0)
    bias_t = packed.bias_folded.to(torch.int64).reshape(g, 1, og).repeat(
        1, kh * kw, 1)
    bias = wrap_int32(bias_t.reshape(-1) + za * (w_all_t.reshape(-1) - w_phase)
                      - zw * za * (kh * kw - 1) * icpg)
    if g == 1:
        return PackedGemmWeights(
            w=w2, bias_folded=bias, k=icpg, n=kh * kw * og,
            input_zero_point=packed.input_zero_point,
            kernel_zero_point=packed.kernel_zero_point)
    return PackedConvWeights(
        w=w2.reshape(1, 1, icpg, g * kh * kw * og), bias_folded=bias,
        kernel_height=1, kernel_width=1, group_input_channels=icpg,
        group_output_channels=kh * kw * og, groups=g,
        input_zero_point=packed.input_zero_point,
        kernel_zero_point=packed.kernel_zero_point)


def _phase_axis(r: int, s: int, pad0: int, k: int):
    """(u, taps, j0) of output offset r along one axis of stride s."""
    u = (r + pad0) % s
    return u, max(0, -(-(k - u) // s)), (r + pad0 - u) // s


def _phases(packed: PackedConvWeights, rparams, strides, padding, w_orig,
            w_all):
    """The DeconvPhases of the phase lowering (qnnpack_tpu/nn/conv.py:
    531-581)."""
    sy, sx = strides
    kh, kw = packed.kernel_height, packed.kernel_width
    icpg = packed.group_input_channels
    za, zw = packed.izp_biased, packed.kzp_biased
    bias = packed.bias_folded.to(torch.int64)
    phases = []
    for r in range(sy):
        u, tu, j0u = _phase_axis(r, sy, padding[0][0], kh)
        for q in range(sx):
            v, tv, j0v = _phase_axis(q, sx, padding[1][0], kw)
            if tu == 0 or tv == 0:
                # No tap reaches the phase: its accumulator is the missing
                # taps' correction alone, one constant a channel.
                acc = wrap_int32(bias + za * w_all - zw * za * kh * kw * icpg)
                const = apply_requant(acc.to(torch.int64)[None, :], rparams)
                phases.append(DeconvPhase(r, q, j0u, j0v, tu, tv, None,
                                          const[0].contiguous()))
                continue
            kuv = w_orig[u::sy].flip(0)[:, v::sx].flip(1).contiguous()
            w_phase = kuv.to(torch.int64).sum(dim=(0, 1, 2))
            rec = PackedConvWeights(
                w=kuv, bias_folded=wrap_int32(
                    bias + za * (w_all - w_phase)
                    - zw * za * (kh * kw - tu * tv) * icpg),
                kernel_height=tu, kernel_width=tv, group_input_channels=icpg,
                group_output_channels=packed.group_output_channels,
                groups=packed.groups,
                input_zero_point=packed.input_zero_point,
                kernel_zero_point=packed.kernel_zero_point)
            phases.append(DeconvPhase(r, q, j0u, j0v, tu, tv, rec, None))
    return tuple(phases)


def deconv_plan(packed: PackedConvWeights, rparams, strides=(1, 1),
                padding=((0, 0), (0, 0)), adjustment=(0, 0),
                dilation=(1, 1)) -> DeconvPlan:
    """The DeconvPlan of `packed` (a transposed record: flipped at pack
    time) at this geometry and requantization, from the record's cache or
    built now and cached there, on the record's device.  A record holds
    its own plans, so a forward given another record never runs a plan
    that is not its own.  Building copies nothing through the host, but a
    CUDA-graph capture must find the plan built (the capture's eager
    warm-up builds it)."""
    key = (tuple(strides), tuple(map(tuple, padding)), tuple(adjustment),
           tuple(dilation), rparams)
    plan = packed.deconv_plans.get(key)
    if plan is not None:
        return plan
    if packed.w.device.type == "cuda" and \
            torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a deconv plan is built outside a CUDA-graph "
                           "capture: run the forward once eagerly first")
    lowering = deconv_lowering(packed, *key[:4])
    if lowering == "unsupported":
        raise ValueError("padding larger than effective kernel is unsupported")
    kw_ = dict(lowering=lowering, strides=key[0], padding=key[1],
               adjustment=key[2], dilation=key[3])
    if lowering == "dilated":
        plan = DeconvPlan(pads=_dilated_pads(packed, *key[1:4]), **kw_)
    else:
        # The phase math indexes the kernel as the caller gave it.
        w_orig = packed.w.flip(0, 1)
        w_all = w_orig.to(torch.int64).sum(dim=(0, 1, 2))
        if lowering == "k_eq_s":
            plan = DeconvPlan(record=_k_eq_s_record(packed, w_orig, w_all),
                              **kw_)
        else:
            plan = DeconvPlan(phases=_phases(packed, rparams, key[0], key[1],
                                             w_orig, w_all), **kw_)
    packed.deconv_plans[key] = plan
    return plan


def depth_to_space(y, sy: int, sx: int, groups: int):
    """[B, H, W, g*sy*sx*Og] phase-major channels -> [B, H*sy, W*sx, g*Og],
    one copy.  For one group the W-interleave stays in the channel axis
    (qnnpack_tpu/nn/conv.py:505-512); groups need the full transpose."""
    b, h, w, c = y.shape
    og = c // (groups * sy * sx)
    if groups == 1:
        y = y.view(b, h, w, sy, sx * og).permute(0, 1, 3, 2, 4)
    else:
        y = y.view(b, h, w, groups, sy, sx, og).permute(0, 1, 4, 2, 5, 3, 6)
    return y.reshape(b, h * sy, w * sx, groups * og)


def deconv_input(a_u8, packed: PackedConvWeights, plan: DeconvPlan):
    """What the plan's launches read: the input, or for the dilated
    lowering at a stride above 1 the input dilated with its zero point
    (taps between the input's pixels then add nothing, which zeros would
    not for izp != 128), a fill and one strided copy."""
    sy, sx = plan.strides
    if plan.lowering != "dilated" or (sy, sx) == (1, 1):
        return a_u8
    b, h, w, c = a_u8.shape
    dil = torch.full((b, (h - 1) * sy + 1, (w - 1) * sx + 1, c),
                     packed.input_zero_point, dtype=torch.uint8,
                     device=a_u8.device)
    dil[:, ::sy, ::sx] = a_u8
    return dil


def _phase_pads(ph: DeconvPhase, nmax: int, mmax: int, h: int, w: int):
    """(padding, first output row, first output column) of a phase's
    stride-1 conv over the whole input: padded with the input zero point
    where its window starts before the input, and past the end for nmax x
    mmax outputs; a window that starts inside the input skips the outputs
    before it (qnnpack_tpu/nn/conv.py:549-560)."""
    offy, offx = ph.j0u - (ph.tu - 1), ph.j0v - (ph.tv - 1)
    pads = ((max(0, -offy), max(0, ph.j0u + nmax - h)),
            (max(0, -offx), max(0, ph.j0v + mmax - w)))
    return pads, max(0, offy), max(0, offx)


def _deconv_dims(packed: PackedConvWeights, plan: DeconvPlan, h: int,
                 w: int):
    (pt, pb), (pl_, pr) = plan.padding
    return (deconv_output_dims(h, pt + pb, plan.adjustment[0],
                               packed.kernel_height, 1, plan.strides[0]),
            deconv_output_dims(w, pl_ + pr, plan.adjustment[1],
                               packed.kernel_width, 1, plan.strides[1]))


def deconv_launches(a_in, packed: PackedConvWeights, rparams,
                    plan: DeconvPlan, h: int, w: int) -> list:
    """The plan's kernel launches on `a_in` (deconv_input's) for an input
    of h x w: k_eq_s one q8gemm (groups 1) or grouped 1x1 q8conv launch;
    phase one stride-1 launch a phase with taps (q8conv, or q8dwconv for
    one channel a group; None for a phase no tap reaches); dilated one
    launch of the record with rhs dilation.  Returns their outputs."""
    if plan.lowering == "dilated":
        pt, pb, pl_, pr = plan.pads
        return [q8conv2d(a_in, packed, rparams, (1, 1),
                         ((pt, pb), (pl_, pr)), plan.dilation)]
    if plan.lowering == "k_eq_s":
        if packed.groups == 1:
            return [q8gemm(a_in, plan.record, rparams)]
        return [q8conv2d(a_in, plan.record, rparams)]
    ho, wo = _deconv_dims(packed, plan, h, w)
    nmax, mmax = -(-ho // plan.strides[0]), -(-wo // plan.strides[1])
    return [None if ph.record is None else
            q8conv2d(a_in, ph.record, rparams, (1, 1),
                     _phase_pads(ph, nmax, mmax, h, w)[0])
            for ph in plan.phases]


def deconv_output(ys: list, packed: PackedConvWeights, plan: DeconvPlan,
                  b: int, h: int, w: int):
    """The deconv's output from deconv_launches' outputs: k_eq_s a
    depth-to-space copy; phase one strided copy a phase into [B, Ho, Wo,
    O] (a constant row for a phase no tap reaches); dilated the launch's
    output itself."""
    if plan.lowering == "dilated":
        return ys[0]
    sy, sx = plan.strides
    if plan.lowering == "k_eq_s":
        return depth_to_space(ys[0], sy, sx, packed.groups)
    ho, wo = _deconv_dims(packed, plan, h, w)
    nmax, mmax = -(-ho // sy), -(-wo // sx)
    o = packed.groups * packed.group_output_channels
    out = torch.empty((b, ho, wo, o), dtype=torch.uint8,
                      device=packed.w.device)
    for ph, y in zip(plan.phases, ys):
        rows = out[:, ph.r::sy, ph.q::sx]
        nr, mr = rows.shape[1:3]
        if nr == 0 or mr == 0:
            continue
        if y is None:
            rows.copy_(ph.const.expand_as(rows))
            continue
        _, i0, j0 = _phase_pads(ph, nmax, mmax, h, w)
        rows.copy_(y[:, i0:i0 + nr, j0:j0 + mr])
    return out


def q8deconv2d(a_u8, packed: PackedConvWeights, rparams, strides=(1, 1),
               padding=((0, 0), (0, 0)), adjustment=(0, 0), dilation=(1, 1)):
    """Quantized transposed convolution (deconvolution.c semantics):

        output[b, sy*iy - pt + dy*dil, sx*ix - pl + dx*dil, o] +=
            (a[b, iy, ix, i] - za)(w[o, dy, dx, i] - zw)

    on the record's DeconvPlan (built on first use; see deconv_plan): the
    input as the launches read it (deconv_input), the kernel launches
    (deconv_launches), and the lowering's copies into the output
    (deconv_output)."""
    plan = deconv_plan(packed, rparams, strides, padding, adjustment,
                       dilation)
    b, h, w, _ = a_u8.shape
    ys = deconv_launches(deconv_input(a_u8, packed, plan), packed, rparams,
                         plan, h, w)
    return deconv_output(ys, packed, plan, b, h, w)
