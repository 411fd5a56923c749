"""q8bmm: the batched activation x activation GEMM kernel and its plain
PyTorch version.

Port of qnnpack_tpu/nn/gemm.py:q8bmm, which the JAX package leaves to XLA
(it has no Pallas form); the port runs it on a hand-written kernel, as it
runs every op of a path.  The CUDA source, with its design and what bounds
it, is csrc/q8bmm.cu: int8 tensor cores on raw uint8 operands.

The kernel reads strided views, so BERT's attention takes its q, k and v
straight out of the qkv projection and writes its context into a [B, S, H]
buffer, with no head-transpose copies.  `bmm_layout` is the one place that
decides how a view is read: A needs K at stride 1; B is read K-major (K at
stride 1, BERT's key view) or N-major (N at stride 1, BERT's value view and
any contiguous B); an output view needs N at stride 1.

`q8attn_masked_cuda` is a layer's masked attention in one kernel,
csrc/q8attn_masked.cu (the scores, the masked softargmax and the context;
MiMo-V2-Flash's path), with no [B, H, S, S] tensor.  Its result is the
three masked steps' byte for byte, so each row's max m and table sum s must be known before its first
probability min((256 t[x + 255 - m] + s / 2) / s, 255) is formed: flash
attention's online rescaling is not exact here, since the table's entries
are rounded.  The kernel sweeps each row's keys three times, recomputing
the scores: the max of the int32 accumulators (requantized once:
requantization does not decrease), the table's sum, then the
probabilities and the context; `q8attn_masked_plain` takes the same steps
(attn_row_div and attn_norm mirror the kernel's divide).

`q8bmm_cuda` takes the plain version for CPU tensors only.  For CUDA
tensors it launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import torch

from ..nn.dtypes import biased_zero_point, u8_to_biased_i8
from ..nn.requant_dispatch import apply_requant
from . import _build


def bmm_acc_plain(a_u8: torch.Tensor, b_u8: torch.Tensor, a_zero_point: int,
                  b_zero_point: int):
    """int32 accumulator [..., M, N] of uint8 [..., M, K] x uint8 [..., K, N]:
    sum_k (a - za)(b - zb) = A'B' - zb' rowsum(A') - za' colsum(B')
    + K za' zb' on biased int8, as an int64 tensor holding the wrapped int32
    value.  Any strides.

    The product runs as a float64 matmul, exact here (|sum| < 2^53)."""
    a = u8_to_biased_i8(a_u8)
    b = u8_to_biased_i8(b_u8)
    za = biased_zero_point(a_zero_point)
    zb = biased_zero_point(b_zero_point)
    k = a.shape[-1]
    acc = torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int64)
    acc = acc - zb * a.to(torch.int64).sum(dim=-1, keepdim=True)
    acc = acc - za * b.to(torch.int64).sum(dim=-2, keepdim=True)
    acc = acc + k * za * zb
    return ((acc + 2**31) & 0xFFFFFFFF) - 2**31


def q8bmm_plain(a_u8: torch.Tensor, b_u8: torch.Tensor, a_zero_point: int,
                b_zero_point: int, rparams):
    """Plain version of the kernel: uint8 [..., M, K] x [..., K, N] ->
    [..., M, N], a new contiguous tensor."""
    return apply_requant(bmm_acc_plain(a_u8, b_u8, a_zero_point,
                                       b_zero_point), rparams)


def _stride(t: torch.Tensor, dim: int) -> int:
    """t's stride along `dim`, 0 where that axis has one element (its
    stride is never used, so it must not narrow a copy)."""
    return 0 if t.shape[dim] == 1 else t.stride(dim)


def _batch(t: torch.Tensor):
    """(z0 stride, z1 stride) of a [G, ...] or [G0, G1, ...] view."""
    if t.dim() == 3:
        return 0, _stride(t, 0)
    return _stride(t, 0), _stride(t, 1)


def bmm_layout(a_u8: torch.Tensor, b_u8: torch.Tensor, out=None):
    """How the kernel reads A [..., M, K] and B [..., K, N] and writes
    [..., M, N], for 3-D or 4-D views with the same leading axes.

    Returns (g, g1, a strides (z0, z1, row), b strides (z0, z1, ld),
    b_kmajor, out strides (z0, z1, row)); `out` None stands for a new
    contiguous output.  B is N-major (ld = the stride of K) where N is at
    stride 1, else K-major (ld = the stride of N) where K is; an axis of
    one element counts as at stride 1.  Raises ValueError on any other
    layout."""
    if a_u8.dim() not in (3, 4) or b_u8.dim() != a_u8.dim():
        raise ValueError(f"expected [G, M, K] and [G, K, N] (or 4-D), got "
                         f"{tuple(a_u8.shape)} and {tuple(b_u8.shape)}")
    lead = a_u8.shape[:-2]
    m, k = a_u8.shape[-2:]
    if b_u8.shape[:-2] != lead or b_u8.shape[-2] != k:
        raise ValueError(f"operands {tuple(a_u8.shape)} and "
                         f"{tuple(b_u8.shape)} do not chain")
    n = b_u8.shape[-1]
    if _stride(a_u8, -1) not in (0, 1):
        raise ValueError(f"a needs K at stride 1, has strides "
                         f"{a_u8.stride()}")
    if _stride(b_u8, -1) in (0, 1):
        b_kmajor, ldb = False, _stride(b_u8, -2)
    elif _stride(b_u8, -2) in (0, 1):
        b_kmajor, ldb = True, _stride(b_u8, -1)
    else:
        raise ValueError(f"b needs K or N at stride 1, has strides "
                         f"{b_u8.stride()}")
    g1 = lead[-1]
    g = g1 * (lead[0] if len(lead) == 2 else 1)
    if out is None:
        so = (m * n * g1 if len(lead) == 2 else 0, m * n, n)
    else:
        if tuple(out.shape) != (*lead, m, n) or out.dtype != torch.uint8:
            raise ValueError(f"out {tuple(out.shape)} {out.dtype}, want "
                             f"{(*lead, m, n)} uint8")
        if _stride(out, -1) not in (0, 1) or (m > 1 and
                                              out.stride(-2) < n):
            raise ValueError(f"out needs N at stride 1 and rows that do "
                             f"not overlap, has strides {out.stride()}")
        so = (*_batch(out), _stride(out, -2))
    return (g, g1, (*_batch(a_u8), _stride(a_u8, -2)),
            (*_batch(b_u8), ldb), b_kmajor, so)


def check_strided_cuda(name: str, t, ndim) -> None:
    """Raise unless `t` is a uint8 CUDA tensor of rank in `ndim` (any
    strides: bmm_layout judges them)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.dtype != torch.uint8:
        raise ValueError(f"{name} must be torch.uint8, got {t.dtype}")
    if t.dim() not in ndim:
        raise ValueError(f"{name} must have rank in {ndim}, got "
                         f"{tuple(t.shape)}")


def q8bmm_cuda(a_u8: torch.Tensor, b_u8: torch.Tensor, a_zero_point: int,
               b_zero_point: int, rparams, out=None):
    """Batched quantized matmul uint8 [G, M, K] x uint8 [G, K, N] -> uint8
    [G, M, N], or the same with two leading axes (any requant scheme; a
    per-channel scale is per column N).  The operands may be strided views
    as `bmm_layout` allows; `out`, a view of that shape with N at stride 1,
    receives the result and is returned."""
    layout = bmm_layout(a_u8, b_u8, out)
    if a_u8.device.type == "cpu" and b_u8.device.type == "cpu":
        y = q8bmm_plain(a_u8, b_u8, a_zero_point, b_zero_point, rparams)
        return y if out is None else out.copy_(y)
    check_strided_cuda("a", a_u8, (3, 4))
    check_strided_cuda("b", b_u8, (3, 4))
    if a_u8.device != b_u8.device:
        raise ValueError(f"a on {a_u8.device}, b on {b_u8.device}")
    *lead, m, k = a_u8.shape
    n = b_u8.shape[-1]
    if out is None:
        out = torch.empty((*lead, m, n), dtype=torch.uint8,
                          device=a_u8.device)
    else:
        check_strided_cuda("out", out, (a_u8.dim(),))
        if out.device != a_u8.device:
            raise ValueError(f"out on {out.device}, a on {a_u8.device}")
    g, g1, sa, sb, b_kmajor, so = layout
    if g == 0 or m == 0 or n == 0:
        return out
    scales, rq = _build.requant_args(rparams, n, a_u8.device)
    _build.launch(
        "qnn_q8bmm", a_u8.device.index or 0, a_u8.data_ptr(), b_u8.data_ptr(),
        None if scales is None else scales.data_ptr(), out.data_ptr(), g, g1,
        m, n, k, *sa, *sb, int(b_kmajor), *so, a_zero_point, b_zero_point,
        *rq, _build.stream_of(a_u8))
    q8bmm_cuda.launches += 1
    return out


q8bmm_cuda.launches = 0


def valid_keys(s: int, window: int, device=None) -> torch.Tensor:
    """bool [S, S]: key j is read by query i.  window 0: causal, j <= i;
    window W > 0: the band i - W + 1 <= j <= i."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(s, device=device)[None, :]
    keep = j <= i
    if window > 0:
        keep &= j > i - window
    return keep


def kv_heads_of(heads: int, kv_heads: int, device=None) -> torch.Tensor:
    """The key/value head each query head reads (grouped-query attention):
    h * kv_heads // heads, which is h // (heads / kv_heads) where that
    divides."""
    return torch.arange(heads, device=device) * kv_heads // heads


# ------------------------------------------------ the fused masked attention
_M32 = 0xFFFFFFFF


def attn_row_div(s: torch.Tensor):
    """The fused kernel's divide of a row (csrc/q8attn_masked.cu
    attn::row_div), for sums s (int64 in [0, 2^32)): (s, -s mod 2^32,
    m = floor(2^32 / s), half).  A zero sum takes m = 2^32 - 1 and half = 255, so that every
    probability of the row is 255, as the reference's 0xFFFFFFFF."""
    q = _M32 // s.clamp(min=1)
    m = torch.where(s > 1, q + ((_M32 - q * s) == s - 1).to(torch.int64),
                    torch.full_like(s, _M32))
    half = torch.where(s == 0, torch.full_like(s, 255), s >> 1)
    return s, (-s) & _M32, m, half


def attn_norm(e: torch.Tensor, div) -> torch.Tensor:
    """min((256 e + s / 2) / s, 255) as the fused kernel computes it
    (csrc/q8attn_masked.cu attn::norm): num = 256 e + half mod 2^32,
    q0 = umulhi(num, m), one correction where num - q0 s >= s.  int64
    arithmetic, each product split in 16-bit halves so that none passes
    2^63."""
    s, neg_s, m, half = div
    num = (e * 256 + half) & _M32
    q0 = (num * (m >> 16) + ((num * (m & 0xFFFF)) >> 16)) >> 16
    r = (num + (((q0 * (neg_s >> 16)) & 0xFFFF) << 16)
         + q0 * (neg_s & 0xFFFF)) & _M32
    return (q0 + (r >= s).to(torch.int64)).clamp(max=255)


def q8attn_masked_plain(q_u8, k_u8, v_u8, zero_point: int, scores_rp, lut,
                        window: int, sinks, context_rp):
    """Plain version of the fused masked attention, in the kernel's steps:
    q [B, H, S, dq], k [B, Hkv, dq, S], v [B, Hkv, S, dv] (query head h
    reads key/value head h Hkv / H) at `zero_point` -> the context
    [B, H, S, dv], a new tensor.  Per row over its valid keys (window 0:
    j <= i; W > 0: i - W < j <= i): the max of the int32 scores'
    accumulators, requantized (requantization does not decrease), and the
    head's sink give m; the table's entries t[x + 255 - m] of the
    requantized scores x and of the sink sum to s (mod 2^32); each
    probability is attn_norm's; the context sums p (v - zero_point) over
    the valid keys.  Four heads at a time bound the memory (their int64
    scores take 2 GB at S = 8,192)."""
    bsz, h, s, _ = q_u8.shape
    hkv, dv = k_u8.shape[1], v_u8.shape[-1]
    dev = q_u8.device
    keep = valid_keys(s, window, dev)
    t = lut.to(device=dev, dtype=torch.int64) & _M32
    kv_of = kv_heads_of(h, hkv, dev)
    out = torch.empty((bsz, h, s, dv), dtype=torch.uint8, device=dev)
    for bi in range(bsz):
        for h0 in range(0, h, 4):
            hs = torch.arange(h0, min(h, h0 + 4), device=dev)
            kv = kv_of[hs]
            acc = bmm_acc_plain(q_u8[bi, hs], k_u8[bi, kv], zero_point,
                                zero_point)
            amax = torch.where(keep, acc, -2**31).amax(-1, keepdim=True)
            m = apply_requant(amax, scores_rp).to(torch.int64)
            sink = None
            if sinks is not None:
                sink = sinks.to(device=dev, dtype=torch.int64)[hs][:, None,
                                                                   None]
                m = torch.maximum(m, sink)
            x = apply_requant(acc, scores_rp).to(torch.int64)
            e = torch.where(keep, t[torch.where(keep, x, m) + 255 - m], 0)
            total = e.sum(-1, keepdim=True)
            if sink is not None:
                total = total + t[sink + 255 - m]
            y = torch.where(keep, attn_norm(e, attn_row_div(total & _M32)),
                            0)
            vv = v_u8[bi, kv].to(torch.int64) - zero_point
            ctx = torch.matmul(y.to(torch.float64), vv.to(torch.float64)).to(
                torch.int64)
            out[bi, hs] = apply_requant(((ctx + 2**31) & _M32) - 2**31,
                                        context_rp)
    return out


def q8attn_masked_cuda(q_u8: torch.Tensor, k_u8: torch.Tensor,
                       v_u8: torch.Tensor, zero_point: int, scores_rp, lut,
                       window: int, sinks, context_rp, out=None):
    """One layer's masked attention in one kernel: the scores of q
    [B, H, S, dq] (dq at stride 1) and k [B, Hkv, dq, S] (dq at stride 1:
    each key's bytes contiguous), requantized by `scores_rp` (fp32), their
    softargmax over each row's valid keys by `lut` (int32 [256], the
    uint32 table; probabilities at scale 1/256, zero point 0) with the
    head's sink of `sinks` (uint8 [H] or None) in its max and sum, and the
    context with v [B, Hkv, S, dv] (dv at stride 1), requantized by
    `context_rp`, into `out` [B, H, S, dv] (dv at stride 1) or a new
    tensor.  Query head h reads key/value head h // (H / Hkv).  No
    [B, H, S, S] tensor is made: the kernel keeps each score in registers
    (csrc/q8attn_masked.cu).  On the card: zero point 128, dq 192 and dv 128
    (MiMo-V2-Flash's heads), a multiple of 4 query heads a key/value head
    (a block takes 4), S up to 32,768, every base and stride a multiple of
    16 bytes."""
    if q_u8.dim() != 4 or k_u8.dim() != 4 or v_u8.dim() != 4:
        raise ValueError(f"expected q [B, H, S, dq], k [B, Hkv, dq, S], v "
                         f"[B, Hkv, S, dv], got {tuple(q_u8.shape)}, "
                         f"{tuple(k_u8.shape)}, {tuple(v_u8.shape)}")
    bsz, h, s, dq = q_u8.shape
    hkv, dv = k_u8.shape[1], v_u8.shape[-1]
    if tuple(k_u8.shape) != (bsz, hkv, dq, s) or \
            tuple(v_u8.shape) != (bsz, hkv, s, dv) or h % hkv or window < 0:
        raise ValueError(f"q {tuple(q_u8.shape)}, k {tuple(k_u8.shape)}, v "
                         f"{tuple(v_u8.shape)}, window {window}")
    if sinks is not None and sinks.numel() != h:
        raise ValueError(f"{sinks.numel()} sinks for {h} heads")
    if out is not None and (tuple(out.shape) != (bsz, h, s, dv) or
                            out.dtype != torch.uint8):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype}, want "
                         f"{(bsz, h, s, dv)} uint8")
    tensors = [q_u8, k_u8, v_u8, lut] + ([] if sinks is None else [sinks])
    if {x.device.type for x in tensors} == {"cpu"}:
        y = q8attn_masked_plain(q_u8, k_u8, v_u8, zero_point, scores_rp,
                                lut, window, sinks, context_rp)
        return y if out is None else out.copy_(y)
    if (dq, dv, zero_point) != (192, 128, 128) or (h // hkv) % 4:
        raise ValueError(f"qk {dq}, v {dv}, zero point {zero_point}, {h} "
                         f"query heads over {hkv}: the kernel takes qk 192, "
                         f"v 128, zero point 128 and a multiple of 4 query "
                         f"heads a key/value head")
    for name, x in (("q", q_u8), ("k", k_u8), ("v", v_u8)):
        check_strided_cuda(name, x, (4,))
        if x.device != q_u8.device:
            raise ValueError(f"{name} on {x.device}, q on {q_u8.device}")
    _build.check_cuda("lut", lut, torch.int32, 1)
    if sinks is not None:
        _build.check_cuda("sinks", sinks, torch.uint8, 1)
    if out is None:
        out = torch.empty((bsz, h, s, dv), dtype=torch.uint8,
                          device=q_u8.device)
    else:
        check_strided_cuda("out", out, (4,))
    for name, x, dim in (("q", q_u8, 3), ("k", k_u8, 2), ("v", v_u8, 3),
                         ("out", out, 3)):
        if _stride(x, dim) not in (0, 1):
            raise ValueError(f"{name} needs its last axis of "
                             f"{tuple(x.shape)} at stride 1, has strides "
                             f"{x.stride()}")
    _, srq = _build.requant_args(scores_rp, 1, q_u8.device)
    scales, crq = _build.requant_args(context_rp, dv, q_u8.device)
    if srq[0] != 1 or scales is not None:
        raise ValueError("q8attn_masked takes fp32 scores and a per-tensor "
                         "context requantization")
    if bsz == 0 or s == 0:
        return out
    _build.launch(
        "qnn_q8attn_masked", q_u8.device.index or 0, q_u8.data_ptr(),
        k_u8.data_ptr(), v_u8.data_ptr(), out.data_ptr(), lut.data_ptr(),
        None if sinks is None else sinks.data_ptr(), bsz, h, hkv, s, dq, dv,
        _stride(q_u8, 0), _stride(q_u8, 1), _stride(q_u8, 2),
        _stride(k_u8, 0), _stride(k_u8, 1), _stride(k_u8, 3),
        _stride(v_u8, 0), _stride(v_u8, 1), _stride(v_u8, 2),
        _stride(out, 0), _stride(out, 1), _stride(out, 2),
        zero_point, window, srq[6], srq[3], srq[4], srq[5], *crq[:6], crq[6],
        _build.stream_of(q_u8))
    q8attn_masked_cuda.launches += 1
    return out


q8attn_masked_cuda.launches = 0
