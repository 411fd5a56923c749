"""The routing and the combine of an expert layer held in part: moe_route
and moe_combine, and their plain PyTorch versions.

An expert layer of R routed experts, k of them a token, held E at a time
on each of R / E devices (expert parallelism): this device holds experts
first .. first + E - 1, scores all R, and computes the part of each
token's result that its E experts give.  The kernels are csrc/moe_route.cu
(the top-k choice and the dispatch of the held experts' rows) and
csrc/moe_combine.cu; between them the experts run on q8gemm's grouped
instance (kernels/q8gemm.py q8gemm_grouped_cuda) and q8swiglu.

Rows are laid out in E segments of `cap` rows, one an expert: expert e's
tokens in token order from row e * cap on; counts[e] of them are live.
cap is the token count, the most any expert can take, so no token is ever
dropped, and every launch is sized for that worst case: the routing is
read on the device only, and a CUDA graph holds the whole layer.

Each `*_cuda` wrapper takes the plain version for CPU tensors only.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn.requant_dispatch import apply_requant
from ..quant.params import FP32Params
from . import _build

KEY_SHIFT_SCORE = 41   # the order key: (sigma + c) << 41 | (r + 2^31) << 9 |
KEY_SHIFT_LOGIT = 9    # (511 - e), largest first


def live_rows(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """bool [E * cap]: the live rows of E segments of `cap` rows, the
    first counts[e] of segment e."""
    r = torch.arange(counts.numel() * cap, device=counts.device)
    return r % cap < counts[r // cap]


@dataclasses.dataclass
class Routing:
    """One expert layer's routing on this device.

    sel:    int32 [T, k] the chosen experts, in the order of their keys
    wts:    int32 [T, k] their weights, summing to about 256
    slot:   int32 [T, k] the row of (t, k) in the held experts' segments,
            -1 where the expert is not held here
    counts: int32 [E] the live rows of each held expert
    rows:   uint8 [E * cap, H] each live row the token's hidden state
            (the rest unspecified)
    """
    sel: torch.Tensor
    wts: torch.Tensor
    slot: torch.Tensor
    counts: torch.Tensor
    rows: torch.Tensor


def route_plain(logits_i32, bias_c, corr, sigmoid_lut, rparams, top_k: int):
    """(sel, wts): the top-k experts of each token and their weights.
    r = logits + bias_c (int32, wrapping) is the router's accumulator, rho
    = requant(r), sigma = sigmoid_lut[rho]; the experts are ordered by
    sigma + corr, then r, then the lower index; w_k = min((256 sigma_k +
    S / 2) / S, 255) with S the chosen sigmas' sum, and 32 each where S is
    0."""
    r = logits_i32.to(torch.int64) + bias_c.to(torch.int64)
    r = ((r + 2**31) & 0xFFFFFFFF) - 2**31
    sig = sigmoid_lut.to(r.device)[apply_requant(r, rparams).to(
        torch.int64)].to(torch.int64)
    n = r.shape[1]
    e = torch.arange(n, device=r.device)
    key = (((sig + corr.to(r.device).to(torch.int64) + 4) << KEY_SHIFT_SCORE)
           | ((r + 2**31) << KEY_SHIFT_LOGIT) | (511 - e))
    sel = key.topk(top_k, dim=1).indices
    chosen = sig.gather(1, sel)
    total = chosen.sum(dim=1, keepdim=True)
    wts = torch.where(total > 0, torch.clamp(
        (256 * chosen + total // 2) // total.clamp(min=1), max=255), 32)
    return sel.to(torch.int32), wts.to(torch.int32)


def moe_route_plain(logits_i32, bias_c, corr, sigmoid_lut, rparams, x_u8,
                    top_k: int, first: int, held: int) -> Routing:
    """Plain version of moe_route (the unlive rows are 0 here)."""
    t, h = x_u8.shape
    sel, wts = route_plain(logits_i32, bias_c, corr, sigmoid_lut, rparams,
                           top_k)
    local = sel.to(torch.int64) - first
    is_held = (local >= 0) & (local < held)
    slot = torch.full_like(sel, -1)
    counts = torch.zeros(held, dtype=torch.int32, device=x_u8.device)
    rows = torch.zeros((held * t, h), dtype=torch.uint8, device=x_u8.device)
    for e in range(held):
        tok, k = torch.nonzero(is_held & (local == e), as_tuple=True)
        slot[tok, k] = (e * t + torch.arange(len(tok), device=x_u8.device)
                        ).to(torch.int32)
        counts[e] = len(tok)
        rows[e * t:e * t + len(tok)] = x_u8[tok]
    return Routing(sel, wts, slot, counts, rows)


def moe_route_cuda(logits_i32, bias_c, corr, sigmoid_lut, rparams, x_u8,
                   top_k: int, first: int, held: int,
                   counts=None) -> Routing:
    """Route tokens [T, H] by the router's int32 partial logits [T, R]
    (q8gemm_partial's, to which the router's bias_c [R] is added): the
    top-k experts by sigmoid score and correction `corr` (int32 [R]), their
    weights, and the held experts' rows gathered into segments of T rows
    (route_plain says how).  Two kernels: one warp a token chooses, then a
    block per held expert and slice of its rows numbers the expert's
    tokens in token order and copies its slice of their rows.  `counts`
    (int32 [held] on the device) receives the live rows if given; it
    outlives the call, so a reader can find the last forward's routing
    there.  While a graph is captured the wrapper counts moe.grid_rows,
    the held * T rows its launches are sized for."""
    t, h = x_u8.shape
    n = logits_i32.shape[1]
    if logits_i32.shape[0] != t or tuple(bias_c.shape) != (n,) or \
            tuple(corr.shape) != (n,) or not 0 < top_k <= min(n, 32) or \
            first < 0 or held < 1 or first + held > n:
        raise ValueError(f"logits {tuple(logits_i32.shape)}, rows "
                         f"{tuple(x_u8.shape)}, top {top_k}, experts "
                         f"{first}..{first + held - 1}")
    if x_u8.device.type == "cpu":
        out = moe_route_plain(logits_i32, bias_c, corr, sigmoid_lut, rparams,
                              x_u8, top_k, first, held)
        if counts is not None:
            counts.copy_(out.counts)
            out.counts = counts
        return out
    if not isinstance(rparams, FP32Params) or n > 512 or h % 16:
        raise ValueError("moe_route takes fp32 requantization, at most 512 "
                         "experts and H % 16 == 0")
    for name, ten, dt in (("logits", logits_i32, torch.int32),
                          ("bias_c", bias_c, torch.int32),
                          ("corr", corr, torch.int32),
                          ("sigmoid_lut", sigmoid_lut, torch.uint8),
                          ("x", x_u8, torch.uint8)):
        _build.check_cuda(name, ten, dt, ten.dim())
    dev = x_u8.device
    sel = torch.empty((t, top_k), dtype=torch.int32, device=dev)
    wts = torch.empty_like(sel)
    slot = torch.empty_like(sel)
    if counts is None:
        counts = torch.empty(held, dtype=torch.int32, device=dev)
    else:
        _build.check_cuda("counts", counts, torch.int32, 1)
    rows = torch.empty((held * t, h), dtype=torch.uint8, device=dev)
    _build.launch("qnn_moe_route", dev.index or 0, logits_i32.data_ptr(),
                  bias_c.data_ptr(), corr.data_ptr(), sigmoid_lut.data_ptr(),
                  x_u8.data_ptr(), sel.data_ptr(), wts.data_ptr(),
                  slot.data_ptr(), counts.data_ptr(), rows.data_ptr(), t, n,
                  top_k, first, held, h, rparams.zero_point, rparams.qmin,
                  rparams.qmax, rparams.scale, _build.stream_of(x_u8))
    moe_route_cuda.launches += 2
    if torch.cuda.is_current_stream_capturing():
        from ..utils import profiling
        profiling.count("moe.grid_rows", held * t)
    return Routing(sel, wts, slot, counts, rows)


moe_route_cuda.launches = 0


def combine_acc_plain(d_u8, slot, wts, zero_point: int):
    """int64 [T, H]: sum over k of wts[t, k] (d[slot[t, k]] - z) where
    slot >= 0 (the held experts' part of each token's result), wrapped to
    int32."""
    live = slot >= 0
    d = d_u8[slot.clamp(min=0).to(torch.int64)].to(torch.int64) - zero_point
    w = torch.where(live, wts, 0).to(torch.int64)
    acc = (d * w[..., None]).sum(dim=1)
    return ((acc + 2**31) & 0xFFFFFFFF) - 2**31


def moe_combine_plain(d_u8, slot, wts, rparams):
    """Plain version of moe_combine."""
    return apply_requant(combine_acc_plain(d_u8, slot, wts,
                                           rparams.zero_point), rparams)


def moe_combine_cuda(d_u8, slot, wts, rparams):
    """The held experts' outputs d [E * cap, H] combined into each token's
    [T, H]: requant(sum_k w_k (d[slot_k] - z)) over the held experts the
    token chose (fp32 requantization, the output's zero point z that of
    d); a token that chose none gets z."""
    if slot.shape != wts.shape or slot.dim() != 2 or d_u8.dim() != 2:
        raise ValueError(f"d {tuple(d_u8.shape)}, slot {tuple(slot.shape)}, "
                         f"wts {tuple(wts.shape)}")
    if d_u8.device.type == "cpu":
        return moe_combine_plain(d_u8, slot, wts, rparams)
    if not isinstance(rparams, FP32Params) or d_u8.shape[1] % 16:
        raise ValueError("moe_combine takes fp32 requantization and "
                         "H % 16 == 0")
    _build.check_cuda("d", d_u8, torch.uint8, 2)
    _build.check_cuda("slot", slot, torch.int32, 2)
    _build.check_cuda("wts", wts, torch.int32, 2)
    t, k = slot.shape
    h = d_u8.shape[1]
    out = torch.empty((t, h), dtype=torch.uint8, device=d_u8.device)
    _build.launch("qnn_moe_combine", d_u8.device.index or 0, d_u8.data_ptr(),
                  slot.data_ptr(), wts.data_ptr(), out.data_ptr(), t, k, h,
                  rparams.zero_point, rparams.qmin, rparams.qmax,
                  rparams.scale, _build.stream_of(d_u8))
    moe_combine_cuda.launches += 1
    return out


moe_combine_cuda.launches = 0
