"""q8gemm: the quantized GEMM kernel and its plain PyTorch version.

Port of qnnpack_tpu/kernels/q8gemm_small.py:q8gemm_small_pallas and
qnnpack_tpu/kernels/q8gemm.py:q8gemm_pallas; the CUDA source, with its
design and what bounds it, is csrc/q8gemm.cu.

`q8gemm_cuda` takes the plain version for CPU tensors only.  For CUDA
tensors it launches the kernel or raises; there is no fallback.

`tile_plan` picks the kernel's block shape and split-K for q8gemm and
q8conv alike (csrc/imma_tile.cuh).  `wgmma_route` says which of q8gemm's
plain launches take the wgmma instance (csrc/wgmma_tile.cuh): those that
do at least the card's ridge of int8 operations a byte
(`config.tune_params`: int8 peak over memory rate), so that the tensor
cores bound them, with A and K as TMA needs them and K within one int32
chain.  Every other launch, and every launch of q8conv, runs the mma.sync
tile.  `_launch` counts each q8gemm launch
in the recorder's counter q8gemm.launches (utils/profiling.py) and each
that took the wgmma instance in q8gemm.wgmma.

`q8gemm_row_sums_cuda` and `q8gemm_presummed_cuda` are the row-sum pair
(the JAX package's nn/gemm.py:q8gemm_row_sums_out / q8gemm_presummed): the
same kernel, whose producer instance also writes rs[m] = sum_n (y[m, n] -
128) and whose consumer instance takes those sums in place of its own row
sums.  Each is one q8gemm launch, counted in `q8gemm_cuda.launches`.

`q8gemm_partial_cuda` runs the kernel's partial instance: the raw int32
sum_k A W' - kzp' * sum_k A of a K slice, with no bias and no
requantization, which K-sharded tensor parallelism sums across ranks
(parallel/mesh.py:gemm_kdim_tp).  Its launches count in its own
`launches`.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

from ..nn.dtypes import u8_to_biased_i8
from ..nn.packing import K_STEP, PackedGemmWeights, wrap_int32
from ..nn.requant_dispatch import apply_requant
from . import _build

# (BM, BN) of the kernel's block shapes, by the C entry's tile id: 0-3
# csrc/imma_tile.cuh's (tile 3 is tile 0 with 128-byte ring stages, 3 of
# them, not 4 of 64), 4 the wgmma instance's (csrc/wgmma_tile.cuh).
TILES = ((128, 128), (128, 64), (64, 64), (128, 128), (128, 256))
DEEP_TILE = 3
WGMMA_TILE = 4
# K (in steps of 64 bytes) from which the 128 x 128 shape takes 128-byte
# stages: 7-12% faster at K = 768..4608, slower at K = 320 and below
# (H100 80GB HBM3, 700 W, scripts/bench_imma.py --tiles).
DEEP_MIN_STEPS = 8
# Deepest K run one int32 mma chain takes (imma_tile.cuh kMaxChainSteps):
# 1024 steps of 64, so |sum A W'| < 255 * 128 * 65536 < 2^31.
MAX_CHAIN_STEPS = 1024
# A split takes at least this many K steps when splitting only for width.
MIN_SPLIT_STEPS = 4


def ridge_of(params) -> float:
    """The card's ridge in int8 operations a byte of device memory: the
    int8 peak of its config.TuneParams over its memory rate (1,979 TOP/s /
    3.35 TB/s, about 591, on the H100); 0 for a card whose peaks are not
    known, which routes no launch to the wgmma instance."""
    if params.int8_peak_tops <= 0 or params.hbm_gbps <= 0:
        return 0.0
    return params.int8_peak_tops / params.hbm_gbps * 1e3


@functools.lru_cache(maxsize=None)
def _ridge(device) -> float:
    from .. import config
    return ridge_of(config.tune_params(device))


def wgmma_route(m: int, n: int, k: int, steps: int, ridge: float,
                a_ptr: int = 0, plain: bool = True) -> bool:
    """Whether a q8gemm launch of M x K x N over `steps` K steps of 64
    bytes takes the wgmma instance on a card of ridge `ridge`: it is the
    plain instance (`plain`: no row sums in or out, not the partial); its
    int8 operations a byte, 2 M N K / (M K + K N + M N), are at or above
    the ridge; A's base `a_ptr` is 16-byte aligned and K % 16 == 0 (TMA's
    rules); K fits one int32 chain (no split); and M fits the kernel's
    int coordinates.

    The SMs the persistent grid fills do not enter: at the ridge a launch
    has a few dozen 128 x 256 tiles or more, and on the H100 the wgmma
    instance was as fast as the mma.sync plan at BERT's b8 out (24 tiles,
    559 operations a byte, below the ridge) and faster at every BERT
    projection from b8 to b128 above it, ffn2 at b8 (24 tiles) among them
    (scripts/bench_imma.py --instances)."""
    return (plain and ridge > 0 and a_ptr % 16 == 0 and k % 16 == 0
            and steps <= MAX_CHAIN_STEPS and m <= 2**31 - TILES[WGMMA_TILE][0]
            and 2 * m * n * k >= ridge * (m * k + k * n + m * n))


def tile_plan(m: int, n: int, steps: int, groups: int, sms: int,
              deep: bool = True):
    """(tile id, splits, steps per split) of one launch of M x N (per
    group) over `steps` K steps of 64 bytes on a card of `sms` SMs.

    The widest block shape that still gives every SM a block; then K is
    split in powers of two while the blocks fill at most one wave and each
    split keeps MIN_SPLIT_STEPS steps; and K deeper than MAX_CHAIN_STEPS
    steps is always split, which keeps every int32 chain exact.  An unsplit
    128 x 128 launch of DEEP_MIN_STEPS or more takes 128-byte stages where
    `deep` allows (a conv whose taps hold whole 128-byte stages)."""
    def blocks(tile):
        bm, bn = TILES[tile]
        return -(-m // bm) * -(-n // bn) * groups

    if n > TILES[1][1] and blocks(0) >= sms:
        tile = 0
    elif blocks(1) >= sms:
        tile = 1
    else:
        tile = 2
    splits = 1
    while (blocks(tile) * splits * 2 <= sms
           and steps >= splits * 2 * MIN_SPLIT_STEPS):
        splits *= 2
    splits = max(splits, -(-steps // MAX_CHAIN_STEPS))
    per = -(-steps // splits)
    splits = -(-steps // per)
    if tile == 0 and splits == 1 and deep and steps >= DEEP_MIN_STEPS:
        tile = DEEP_TILE
    return tile, splits, per


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# Counters an eager launch takes, per (device, stream handle); 4096 covers
# every split launch but one whose K alone forces the split.
COUNTERS = 4096
_counters = {}
_graph = threading.local()


def new_counters(device) -> torch.Tensor:
    """A zeroed set of split-K counters on `device`."""
    return torch.zeros(COUNTERS, dtype=torch.int32, device=device)


@contextlib.contextmanager
def graph_counters(counters: torch.Tensor):
    """Within the block, every split-K launch of this thread counts on
    `counters` (made with new_counters before a CUDA-graph capture).  A
    capture runs on one capture stream, so counters keyed by stream would
    be shared by every graph captured there, and two of them replayed at
    once on two streams would count each other's tiles; a graph that holds
    counters of its own (ops/base.py:capture) cannot."""
    prev = getattr(_graph, "counters", None)
    _graph.counters = counters
    try:
        yield counters
    finally:
        _graph.counters = prev


def _split_counters(device, stream: int, blocks: int) -> torch.Tensor:
    """The split-K counters of a launch on `stream` (a CUDA stream handle)
    of `device`: one int32 per output tile, all 0 between launches (the
    kernel's last block of each tile sets its counter back to 0).  Launches
    on one stream run in order, so only launches on another stream could
    be in flight at once, and those count on counters of their own.  The
    wrappers launch on the current stream, so the zeroing below is queued
    ahead of the first launch that reads them.  Under graph_counters the
    launch takes the graph's counters; a split launch captured without
    them raises."""
    own = getattr(_graph, "counters", None)
    if own is not None:
        if own.device != torch.device(device) or own.numel() < blocks:
            raise RuntimeError(
                f"graph counters {own.numel()} on {own.device} for a "
                f"split-K launch of {blocks} tiles on {device}")
        return own
    key = (torch.device(device), stream)
    if key[0].type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a split-K launch captured without counters of its graph's own "
            "would share them with every graph captured on this stream: "
            "capture through ops.base.capture or jit_forward")
    counters = _counters.get(key)
    if counters is None or counters.numel() < blocks:
        counters = torch.zeros(max(blocks, COUNTERS), dtype=torch.int32,
                               device=device)
        _counters[key] = counters
    return counters


def plan_launch(device, stream: int, m: int, n: int, steps: int,
                groups: int = 1, deep: bool = True):
    """tile_plan on `device` and its split-K scratch for a launch on
    `stream`: (workspace or None, [tile, splits, steps per split, workspace
    ptr, counters ptr]), the arguments that the C entries of q8gemm and
    q8conv take.  The workspace holds each split's int32 partial tile; once
    the caller drops it, the caching allocator hands it only to later work
    on the same stream; under a CUDA-graph capture it comes from the
    graph's private pool, which keeps it for the graph's replays."""
    tile, splits, per = tile_plan(m, n, steps, groups, _sm_count(device),
                                  deep)
    if splits == 1:
        return None, [tile, 1, per, 0, 0]
    bm, bn = TILES[tile]
    blocks = -(-m // bm) * -(-n // bn) * groups
    work = torch.empty(blocks * splits * (bm * bn + bm), dtype=torch.int32,
                       device=device)
    return work, [tile, splits, per, work.data_ptr(),
                  _split_counters(device, stream, blocks).data_ptr()]


def gemm_acc_plain(a_u8: torch.Tensor, w: torch.Tensor,
                   bias_folded: torch.Tensor, kzp_biased: int,
                   row_sums: torch.Tensor | None = None):
    """int32 accumulator [..., N] of uint8 [..., K] x biased int8 [K, N]:
    sum_k A'W' - kzp' * sum_k A' + bias', as an int64 tensor holding the
    wrapped int32 value; `row_sums` [...] stands for sum_k A' where given.

    The product runs as a float64 matmul, which is exact here (every partial
    sum is an integer below 2^53) and runs on the CPU and the GPU alike."""
    a = u8_to_biased_i8(a_u8)
    acc = torch.matmul(a.to(torch.float64), w.to(torch.float64)).to(
        torch.int64)
    acc = acc + bias_folded.to(torch.int64)
    if kzp_biased != 0:
        if row_sums is None:
            row_sums = a.to(torch.int64).sum(dim=-1)
        acc = acc - kzp_biased * row_sums.to(torch.int64)[..., None]
    return ((acc + 2**31) & 0xFFFFFFFF) - 2**31


def partial_acc_plain(a_u8: torch.Tensor, w: torch.Tensor,
                      kzp_biased: int) -> torch.Tensor:
    """int32 [..., N]: sum_k A W' - kzp' * sum_k A over the raw uint8 A
    (wrapped), the partial instances' output.  With c = bias' - 128 sum W'
    + 128 K kzp' the K slices' partials plus c are the reference's
    accumulator mod 2^32; a slice's partial alone is not the JAX shard's
    (which sums A - 128), so only sums of them compare.  Exact in float64
    as gemm_acc_plain."""
    acc = torch.matmul(a_u8.to(torch.float64), w.to(torch.float64)).to(
        torch.int64)
    if kzp_biased != 0:
        acc = acc - kzp_biased * a_u8.to(torch.int64).sum(dim=-1)[..., None]
    return wrap_int32(acc)


def q8gemm_plain(a_u8: torch.Tensor, packed: PackedGemmWeights, rparams):
    """Plain version of the kernel: uint8 [M, K] -> uint8 [M, N]."""
    return apply_requant(gemm_acc_plain(a_u8, packed.w, packed.bias_folded,
                                        packed.kzp_biased), rparams)


def row_sums_plain(y_u8: torch.Tensor) -> torch.Tensor:
    """int32 [M]: sum_n (y[m, n] - 128), wrapped as the JAX int32 sum."""
    s = y_u8.to(torch.int64).sum(dim=-1) - 128 * y_u8.shape[-1]
    return (((s + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def q8gemm_presummed_plain(a_u8: torch.Tensor, row_sums: torch.Tensor,
                           packed: PackedGemmWeights, rparams):
    """Plain version of the consumer: q8gemm_plain with sum_k A' given."""
    return apply_requant(gemm_acc_plain(a_u8, packed.w, packed.bias_folded,
                                        packed.kzp_biased, row_sums), rparams)


def _check_gemm(a_u8: torch.Tensor, packed: PackedGemmWeights) -> None:
    if a_u8.dim() != 2 or a_u8.shape[1] != packed.k:
        raise ValueError(f"activations {tuple(a_u8.shape)} do not match "
                         f"K = {packed.k}")


def q8gemm_cuda(a_u8: torch.Tensor, packed: PackedGemmWeights, rparams):
    """Quantized GEMM uint8 [M, K] -> uint8 [M, N] (any requant scheme)."""
    _check_gemm(a_u8, packed)
    if a_u8.device.type == "cpu":
        return q8gemm_plain(a_u8, packed, rparams)
    return _launch(a_u8, packed, rparams)


def q8gemm_row_sums_cuda(a_u8: torch.Tensor, packed: PackedGemmWeights,
                         rparams):
    """The producer: (y uint8 [M, N], rs int32 [M]) with y the quantized
    GEMM and rs[m] = sum_n (y[m, n] - 128), from one launch whose epilogue
    sums the bytes it stores."""
    _check_gemm(a_u8, packed)
    if a_u8.device.type == "cpu":
        y = q8gemm_plain(a_u8, packed, rparams)
        return y, row_sums_plain(y)
    # Zeroed on the launch's stream: a memset node inside a capture.
    rs = torch.zeros(a_u8.shape[0], dtype=torch.int32, device=a_u8.device)
    return _launch(a_u8, packed, rparams, rs_out=rs), rs


def q8gemm_presummed_cuda(a_u8: torch.Tensor, row_sums: torch.Tensor,
                          packed: PackedGemmWeights, rparams):
    """The consumer: the quantized GEMM of uint8 [M, K] with the row sums
    sum_k (A[m, k] - 128) given as int32 [M] (the producer's rs), so the
    kernel sums no row."""
    _check_gemm(a_u8, packed)
    if tuple(row_sums.shape) != (a_u8.shape[0],):
        raise ValueError(f"row sums {tuple(row_sums.shape)} for "
                         f"{a_u8.shape[0]} rows")
    if a_u8.device.type == "cpu":
        return q8gemm_presummed_plain(a_u8, row_sums, packed, rparams)
    _build.check_cuda("row_sums", row_sums, torch.int32, 1)
    if row_sums.device != a_u8.device:
        raise ValueError(f"row sums on {row_sums.device}, activations on "
                         f"{a_u8.device}")
    return _launch(a_u8, packed, rparams, rs_in=row_sums)


def q8gemm_partial_cuda(a_u8: torch.Tensor, packed: PackedGemmWeights):
    """The partial instance: uint8 [M, K] -> int32 [M, N], sum_k A W' -
    kzp' * sum_k A over the record's K (see partial_acc_plain)."""
    _check_gemm(a_u8, packed)
    if a_u8.device.type == "cpu":
        return partial_acc_plain(a_u8, packed.w, packed.kzp_biased)
    _check_launch(a_u8, packed)
    m = a_u8.shape[0]
    kp = packed.w_kmajor.shape[1]
    out = torch.empty((m, packed.n), dtype=torch.int32, device=a_u8.device)
    stream = _build.stream_of(a_u8)
    work, plan = plan_launch(a_u8.device, stream, m, packed.n, kp // K_STEP)
    _build.launch(
        "qnn_q8gemm_partial", a_u8.device.index or 0, a_u8.data_ptr(),
        packed.w_kmajor.data_ptr(), out.data_ptr(), m, packed.n, packed.k,
        kp, packed.kzp_biased, *plan, stream)
    q8gemm_partial_cuda.launches += 1
    return out


q8gemm_partial_cuda.launches = 0


def _check_launch(a_u8, packed: PackedGemmWeights) -> None:
    """Raise unless the launch's operands are CUDA tensors that fit."""
    _build.check_cuda("a", a_u8, torch.uint8, 2)
    _build.check_cuda("w_kmajor", packed.w_kmajor, torch.int8, 2)
    _build.check_cuda("bias_c", packed.bias_c, torch.int32, 1)
    if packed.w_kmajor.device != a_u8.device:
        raise ValueError(f"weights on {packed.w_kmajor.device}, activations "
                         f"on {a_u8.device}")
    n, kp = packed.w_kmajor.shape
    if n != packed.n or kp % K_STEP or kp < packed.k:
        raise ValueError(f"w_kmajor shape {(n, kp)} does not fit "
                         f"{(packed.k, packed.n)}")


def _launch(a_u8, packed: PackedGemmWeights, rparams, rs_in=None,
            rs_out=None):
    """One launch of the kernel on CUDA tensors (the plain instance, or
    with `rs_in` the consumer's, with `rs_out` the producer's); the plain
    instance on the wgmma tile where wgmma_route says so."""
    _check_launch(a_u8, packed)
    kp = packed.w_kmajor.shape[1]
    m = a_u8.shape[0]
    scales, rq = _build.requant_args(rparams, packed.n, a_u8.device)
    out = torch.empty((m, packed.n), dtype=torch.uint8, device=a_u8.device)
    stream = _build.stream_of(a_u8)
    steps = kp // K_STEP
    wgmma = wgmma_route(m, packed.n, packed.k, steps, _ridge(a_u8.device),
                        a_u8.data_ptr(), rs_in is None and rs_out is None)
    if wgmma:
        work, plan = None, [WGMMA_TILE, 1, steps, 0, 0]
    else:
        work, plan = plan_launch(a_u8.device, stream, m, packed.n, steps)
    _build.launch(
        "qnn_q8gemm", a_u8.device.index or 0, a_u8.data_ptr(),
        packed.w_kmajor.data_ptr(), packed.bias_c.data_ptr(),
        None if scales is None else scales.data_ptr(), out.data_ptr(),
        m, packed.n, packed.k, kp, packed.kzp_biased, *plan, *rq,
        None if rs_in is None else rs_in.data_ptr(),
        None if rs_out is None else rs_out.data_ptr(), stream)
    q8gemm_cuda.launches += 1
    # Imported here: utils/__init__ imports nn.conv, which imports this
    # module through kernels.q8conv.
    from ..utils import profiling
    profiling.count("q8gemm.launches")
    if wgmma:
        profiling.count("q8gemm.wgmma")
    return out


q8gemm_cuda.launches = 0


def q8gemm_grouped_plain(a_u8: torch.Tensor, packed, counts: torch.Tensor,
                         cap: int, rparams):
    """Plain version of the grouped instance: A [E * cap, K], expert e's
    rows at e * cap, of which the first counts[e] are live -> [E * cap, N],
    each live row through its expert's weights; the other rows are 0 here
    and unspecified in the kernel's output."""
    from .moe import live_rows
    e = packed.experts
    a = a_u8.reshape(e, cap, packed.k)
    acc = torch.cat([gemm_acc_plain(a[i], packed.w[i], packed.bias_folded[i],
                                    packed.kzp_biased) for i in range(e)])
    y = apply_requant(acc, rparams)
    live = live_rows(counts.to(a_u8.device), cap)
    return torch.where(live[:, None], y, torch.zeros_like(y))


def q8gemm_grouped_cuda(a_u8: torch.Tensor, packed, counts: torch.Tensor,
                        cap: int, rparams):
    """The grouped GEMM of an expert layer: A [E * cap, K] holds expert
    e's rows at e * cap, and counts (int32 [E], on the device, written by
    an earlier kernel) says how many of them are live.  One launch of the
    wgmma instance walks every live 128 x 256 tile of every expert; the
    persistent grid is sized for the worst case (every row live), and the
    count is read on the device, so a CUDA graph holds the launch
    whatever the routing.  The wrapper counts moe.grouped_launches while
    a graph is being captured."""
    if a_u8.dim() != 2 or a_u8.shape != (packed.experts * cap, packed.k) \
            or tuple(counts.shape) != (packed.experts,):
        raise ValueError(f"rows {tuple(a_u8.shape)}, counts "
                         f"{tuple(counts.shape)} for {packed.experts} "
                         f"experts of {cap} rows and K = {packed.k}")
    if a_u8.device.type == "cpu":
        return q8gemm_grouped_plain(a_u8, packed, counts, cap, rparams)
    _build.check_cuda("a", a_u8, torch.uint8, 2)
    _build.check_cuda("counts", counts, torch.int32, 1)
    _build.check_cuda("w_kmajor", packed.w_kmajor, torch.int8, 2)
    if packed.n % TILES[WGMMA_TILE][1] or packed.k % 16 or \
            a_u8.data_ptr() % 16:
        raise ValueError(f"the grouped instance takes N % "
                         f"{TILES[WGMMA_TILE][1]} == 0, K % 16 == 0 and a "
                         f"16-byte aligned A, got N {packed.n}, K {packed.k}")
    scales, rq = _build.requant_args(rparams, packed.n, a_u8.device)
    if scales is not None:
        raise ValueError("q8gemm_grouped takes per-tensor requantization")
    out = torch.empty((a_u8.shape[0], packed.n), dtype=torch.uint8,
                      device=a_u8.device)
    _build.launch(
        "qnn_q8gemm_grouped", a_u8.device.index or 0, a_u8.data_ptr(),
        packed.w_kmajor.data_ptr(), packed.bias_c.data_ptr(), out.data_ptr(),
        counts.data_ptr(), packed.experts, cap, packed.n, packed.k,
        packed.w_kmajor.shape[1], packed.kzp_biased, *rq,
        _build.stream_of(a_u8))
    q8gemm_grouped_cuda.launches += 1
    if torch.cuda.is_current_stream_capturing():
        from ..utils import profiling
        profiling.count("moe.grouped_launches")
    return out


q8gemm_grouped_cuda.launches = 0
