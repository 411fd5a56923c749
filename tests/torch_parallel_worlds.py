"""Spawned gloo worlds for the parallel tests of the port
(tests/test_torch_parallel*.py, tests/test_torch_multihost.py).

`run_world(size, cases, tmp_path)` starts `size` processes with the spawn
start method, joins them into one gloo world through a file:// store under
tmp_path, runs the module-level function `cases(rank, size)` in each, and
returns every rank's results (a dict of numpy arrays and values; an
expected rejection as ("raised", type name, message)).  A world that does
not finish within WORLD_TIMEOUT_S is killed, so no process outlives its
test.  The inputs of each case come from a numpy seed (`case_rng`), so the
test rebuilds the same ones for the JAX side.

This module imports only torch, numpy and the port: the processes it
starts never import jax.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import sys
import time
import traceback
import zlib
from pathlib import Path

import numpy as np
import torch

WORLD_TIMEOUT_S = 120
ROOT = str(Path(__file__).resolve().parents[1])
SCHEMES = ("q31", "fp32", "precise", "gemmlowp", "pc")
# (n_data, n_model) meshes of the MobileNetV2 cases (tests/test_parallel.py).
MESH_SHAPES = ((8, 1), (1, 8), (4, 2), (2, 4))
SPATIAL = ((3, 1, 1, 1), (3, 2, 1, 0), (5, 1, 2, 2))  # kh, s, pt, pb
PIPELINES = ((2, 4), (4, 4), (8, 3))  # n_stages, n_micro
EXPERTS = ((8, 2), (8, 8), (4, 4))  # groups, n_shards
KZPS = (103, 128)


def case_rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def u8(rng, *shape):
    return rng.integers(0, 256, shape, dtype=np.int64).astype(np.uint8)


def i32(rng, lo, hi, *shape):
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


# --------------------------------------------------------------- inputs
def tiny_mobilenet(make, seed, batch=8):
    """(params, spec, x) of the tiny MobileNetV2 of tests/test_parallel.py
    from `make` (either package's build_mobilenet_v2, with its keywords)."""
    rng = np.random.default_rng(seed)
    params, spec = make(
        rng, input_size=32, num_classes=16, requant="fp32",
        cfg=[(1, 8, 1, 1), (6, 16, 2, 2)], stem_channels=8, head_channels=64)
    x = rng.integers(0, 256, (batch, 32, 32, 3),
                     dtype=np.int64).astype(np.uint8)
    return params, spec, x


def spatial_inputs(kh, s, pt, pb, n):
    rng = case_rng("spatial", kh, s, pt, pb, n)
    return dict(x=u8(rng, 2, 32, 12, 8), k=u8(rng, 16, kh, kh, 8),
                bias=i32(rng, -500, 500, 16),
                pad=((pt, pb), (kh // 2, kh // 2)), strides=(s, s))


def pipeline_inputs(n_stages, n_micro, mb=4, dim=32):
    rng = case_rng("pipeline", n_stages, n_micro)
    stages = [(u8(rng, dim, dim), i32(rng, -100, 100, dim))
              for _ in range(n_stages)]
    return dict(stages=stages, x=u8(rng, n_micro, mb, dim))


def kdim_inputs(n, scheme, kzp):
    rng = case_rng("kdim", n, scheme, kzp)
    return dict(a=u8(rng, 6, 64), w=u8(rng, 24, 64),
                bias=i32(rng, -500, 500, 24),
                scales=rng.uniform(1e-3, 8e-3, 24))


def ic_inputs(n, kzp):
    rng = case_rng("ic", n, kzp)
    return dict(x=u8(rng, 2, 9, 9, 16), k=u8(rng, 12, 3, 3, 16),
                bias=i32(rng, -500, 500, 12))


def ep_inputs(groups, n):
    rng = case_rng("ep", groups, n)
    return dict(x=u8(rng, 2, 10, 10, groups * 4),
                k=u8(rng, groups * 6, 3, 3, 4),
                bias=i32(rng, -500, 500, groups * 6))


def column_inputs():
    """Records of each layout with per-channel scales, for ColumnShard:
    a GEMM, a dense 3x3, a grouped 3x3 (8 groups) and a depthwise 3x3."""
    rng = case_rng("columns")
    return dict(
        a=u8(rng, 2, 6, 6, 16),
        gemm=(u8(rng, 32, 16), i32(rng, -500, 500, 32),
              rng.uniform(1e-3, 8e-3, 32)),
        dense=(u8(rng, 32, 3, 3, 16), i32(rng, -500, 500, 32),
               rng.uniform(1e-4, 1e-3, 32), 1),
        grouped=(u8(rng, 32, 3, 3, 2), i32(rng, -500, 500, 32),
                 rng.uniform(1e-3, 8e-3, 32), 8),
        depthwise=(u8(rng, 16, 3, 3, 1), i32(rng, -500, 500, 16),
                   rng.uniform(1e-3, 8e-3, 16), 16))


def requant(make, per_channel, scheme, scales, scale=0.004, zp=117):
    if scheme == "pc":
        return per_channel(scales, zp)
    return make(scheme, scale, zp)


def raised(fn):
    """("raised", type, message) of the exception fn() raises, or the
    value it returns."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - the test reads the type
        return ("raised", type(exc).__name__, str(exc))


# ---------------------------------------------------------------- cases
def _port():
    from qnnpack_tpu_torch import parallel
    from qnnpack_tpu_torch.models import mobilenet_v2 as mv2
    from qnnpack_tpu_torch.nn import conv, gemm
    from qnnpack_tpu_torch.nn.packing import pack_gemm_weights
    from qnnpack_tpu_torch.nn.requant_dispatch import make_requant_params
    from qnnpack_tpu_torch.quant.params import compute_per_channel_fp32_params
    return dict(P=parallel, mv2=mv2, conv=conv, gemm=gemm,
                pack_gemm=pack_gemm_weights, make=make_requant_params,
                pc=compute_per_channel_fp32_params)


def _build_mobilenet(mv2):
    def make(rng, **kw):
        return mv2.build_mobilenet_v2(rng, device="cpu", **kw)
    return make


def cases_mobilenet(rank, size):
    """tests/test_parallel.py: the tiny MobileNetV2 on every mesh shape,
    the mesh's shape and its rejection, and ColumnShard on per-channel
    records of each layout."""
    t = _port()
    P, mv2 = t["P"], t["mv2"]
    params, spec, x = tiny_mobilenet(_build_mobilenet(mv2), 21)
    out = {}
    for n_data, n_model in MESH_SHAPES:
        mesh = P.make_mesh(n_data, n_model, device="cpu")
        sharded = P.shard_params(params, mesh)
        fwd = P.sharded_inference_fn(
            lambda p, v: mv2.mobilenet_v2_forward(p, spec, v), mesh)
        bs = P.batch_sharding(mesh)
        y = bs.gather(fwd(sharded, bs.shard(torch.from_numpy(x))))
        out[f"mobilenet {n_data}x{n_model}"] = y.numpy()
        out[f"column shards {n_data}x{n_model}"] = sum(
            type(p).__name__ == "ColumnShard" for p in sharded)
        if (n_data, n_model) == (1, 8):
            out.update(_column_cases(t, mesh))
    mesh = P.make_mesh(4, 2, device="cpu")
    out["mesh shape"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape))
    out["mesh 3x2"] = raised(lambda: P.make_mesh(3, 2, device="cpu"))
    return out


def _column_cases(t, mesh):
    """Each layout with per-channel scales through shard_params on an
    n_model = 8 mesh; the nn functions gather every rank's channels."""
    P, conv, gemm = t["P"], t["conv"], t["gemm"]
    d = column_inputs()
    a = torch.from_numpy(d["a"])
    out = {}
    w, b, s = d["gemm"]
    rec = t["pack_gemm"](w, b, 121, 103)
    (shard,) = P.shard_params([rec], mesh)
    out["columns gemm"] = gemm.q8gemm(a, shard, t["pc"](s, 117)).numpy()
    for name in ("dense", "grouped", "depthwise"):
        k, b, s, groups = d[name]
        rec = conv.pack_conv_weights(k, b, 121, 103, groups)
        (shard,) = P.shard_params([rec], mesh)
        out[f"columns {name}"] = conv.q8conv2d(
            a, shard, t["pc"](s, 117), padding=((1, 1), (1, 1))).numpy()
    return out


def cases_axes(rank, size):
    """tests/test_parallel_axes.py at `size` shards: the spatial halo
    conv, the pipeline, K-dim and input-channel TP and EP, with their
    rejections."""
    t = _port()
    P, conv, gemm = t["P"], t["conv"], t["gemm"]
    make, pc = t["make"], t["pc"]
    from torch.distributed.device_mesh import init_device_mesh
    line = init_device_mesh("cpu", (size,), mesh_dim_names=("sp",))
    grid = P.make_mesh(1, size, device="cpu")
    out = {}
    for kh, s, pt, pb in SPATIAL:
        d = spatial_inputs(kh, s, pt, pb, size)
        packed = conv.pack_conv_weights(d["k"], d["bias"], 121, 103)
        band = d["x"].shape[1] // size
        x = torch.from_numpy(d["x"][:, rank * band:(rank + 1) * band])
        out[f"spatial {kh} {s} {pt} {pb}"] = P.spatial_conv2d(
            x, packed, make("fp32", 0.004, 117), line, axis="sp",
            strides=d["strides"], padding=d["pad"]).numpy()
    for n_stages, n_micro in PIPELINES:
        if n_stages != size:
            continue
        d = pipeline_inputs(n_stages, n_micro)
        rp = make("q31", 0.01, 128)
        stages = P.stack_stage_params(
            [t["pack_gemm"](w, b, 121, 103) for w, b in d["stages"]])
        out[f"pipeline {n_stages} {n_micro}"] = P.pipeline_apply(
            lambda p, v: gemm.q8gemm(v, p, rp), stages,
            torch.from_numpy(d["x"]), line, axis="sp").numpy()
    for scheme in SCHEMES:
        for kzp in KZPS:
            d = kdim_inputs(size, scheme, kzp)
            packed = t["pack_gemm"](d["w"], d["bias"], 121, kzp)
            ks = 64 // size
            a = torch.from_numpy(d["a"][:, rank * ks:(rank + 1) * ks])
            out[f"kdim {scheme} {kzp}"] = P.gemm_kdim_tp(
                a, packed, requant(make, pc, scheme, d["scales"]),
                grid).numpy()
    for kzp in KZPS:
        if size > 4:
            break
        d = ic_inputs(size, kzp)
        packed = conv.pack_conv_weights(d["k"], d["bias"], 121, kzp)
        cs = 16 // size
        x = torch.from_numpy(d["x"][..., rank * cs:(rank + 1) * cs])
        out[f"ic {kzp}"] = P.conv_ic_tp(
            x, packed, make("q31", 0.004, 117), grid, strides=(2, 2),
            padding=((1, 1), (1, 1))).numpy()
    for groups, n in EXPERTS:
        if n != size:
            continue
        d = ep_inputs(groups, n)
        packed = conv.pack_conv_weights(d["k"], d["bias"], 121, 103, groups)
        cs = d["x"].shape[-1] // n
        x = torch.from_numpy(d["x"][..., rank * cs:(rank + 1) * cs])
        out[f"ep {groups}"] = P.grouped_conv2d_ep(
            x, packed, make("q31", 0.004, 117), line, axis="sp",
            padding=((1, 1), (1, 1))).numpy()
    if size == 4:
        out.update(_rejections(t, line, grid))
    return out


def _rejections(t, line, grid):
    """The rejections of tests/test_parallel_axes.py and their kin, on
    four shards; each raises before any collective, on every rank."""
    P, conv = t["P"], t["conv"]
    rng = case_rng("rejections")
    rp = t["make"]("fp32", 0.004, 117)
    k = conv.pack_conv_weights(u8(rng, 8, 3, 3, 8), None, 121, 103)
    grouped = conv.pack_conv_weights(u8(rng, 8, 3, 3, 4), None, 121, 103, 2)
    odd = conv.pack_conv_weights(u8(rng, 8, 3, 3, 6), None, 121, 103)
    w30 = t["pack_gemm"](u8(rng, 8, 30), None, 121, 103)
    band = torch.zeros((1, 7, 8, 8), dtype=torch.uint8)
    return {
        "reject spatial split": raised(lambda: P.spatial_conv2d(
            band, k, rp, line, axis="sp", strides=(2, 2),
            padding=((1, 0), (1, 1)))),
        "reject spatial pad": raised(lambda: P.spatial_conv2d(
            band, k, rp, line, axis="sp", padding=((1, 0), (1, 1)))),
        "reject kdim": raised(lambda: P.gemm_kdim_tp(
            torch.zeros((2, 30), dtype=torch.uint8), w30, rp, grid)),
        "reject ic grouped": raised(lambda: P.conv_ic_tp(
            torch.zeros((1, 4, 4, 2), dtype=torch.uint8), grouped, rp,
            grid)),
        "reject ic channels": raised(lambda: P.conv_ic_tp(
            torch.zeros((1, 4, 4, 2), dtype=torch.uint8), odd, rp, grid)),
        "reject ep": raised(lambda: P.grouped_conv2d_ep(
            torch.zeros((1, 4, 4, 4), dtype=torch.uint8), grouped, rp,
            line, axis="sp")),
    }


def host_batches(hosts=2, rows=8):
    rng = case_rng("hosts")
    return [u8(rng, rows, 5, 7) for _ in range(hosts)]


def cases_multihost(rank, size):
    """tests/test_multihost.py in a world of two "hosts" of four ranks
    (LOCAL_WORLD_SIZE 4): hybrid meshes and their rejections, per-host
    batches, the TP x DP MobileNetV2 forward from per-host batches,
    SliceRecovery and HealthMonitor -> SliceRecovery.recover."""
    t = _port()
    P, mv2 = t["P"], t["mv2"]
    from qnnpack_tpu_torch.serving import HealthMonitor
    out = {"init again": P.distributed_init(device="cpu")}
    for n_model in (1, 2, 4):
        mesh = P.make_hybrid_mesh(n_model, device="cpu")
        out[f"hybrid {n_model}"] = (tuple(mesh.mesh_dim_names),
                                    tuple(mesh.shape),
                                    mesh.mesh.tolist())
    out["hybrid 3"] = raised(lambda: P.make_hybrid_mesh(3, device="cpu"))
    out["hybrid 8"] = raised(lambda: P.make_hybrid_mesh(8, device="cpu"))

    host = rank // int(os.environ["LOCAL_WORLD_SIZE"])
    mesh = P.make_hybrid_mesh(2, device="cpu")
    bs = P.batch_sharding(mesh)
    g = P.host_local_batch_to_global(host_batches()[host], mesh)
    out["host rows"] = g.numpy()
    out["host batch"] = bs.gather(g).numpy()

    params, spec, x = tiny_mobilenet(_build_mobilenet(t["mv2"]), 9)

    def forward(p, v):
        return mv2.mobilenet_v2_forward(p, spec, v)

    local = x[host * 4:(host + 1) * 4]  # each host feeds its own rows
    fwd = P.sharded_inference_fn(forward, mesh)
    y = fwd(P.shard_params(params, mesh),
            P.host_local_batch_to_global(local, mesh))
    out["two hosts"] = bs.gather(y).numpy()

    rec = P.SliceRecovery.snapshot(params, P.shard_params, n_model=2,
                                   device="cpu")
    xs = P.batch_sharding(rec.mesh).shard(torch.from_numpy(x))
    want = P.sharded_inference_fn(forward, rec.mesh)(rec.device_params, xs)
    rec.device_params = None  # a failure: the device state is gone
    new_params = rec.recover()
    got = P.sharded_inference_fn(forward, rec.mesh)(
        new_params, P.batch_sharding(rec.mesh).shard(torch.from_numpy(x)))
    out["recovery"] = (rec.recoveries,
                       P.batch_sharding(rec.mesh).gather(want).numpy(),
                       P.batch_sharding(rec.mesh).gather(got).numpy())

    w = case_rng("monitor").integers(0, 255, (4, 4),
                                     dtype=np.int64).astype(np.uint8)
    rec = P.SliceRecovery.snapshot(
        {"w": w}, lambda p, m: {k: torch.as_tensor(v) for k, v in p.items()},
        device="cpu")
    mon = HealthMonitor(deadline_s=-1.0, on_failure=rec.recover,
                        devices=["cpu"])
    out["monitor"] = (mon.probe_once(), mon.healthy, rec.recoveries,
                      rec.device_params["w"].numpy())
    return out


# ---------------------------------------------------------------- worlds
def _worker(rank, size, store, cases, out_dir, env):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    os.environ.update(env)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank % int(
        env.get("LOCAL_WORLD_SIZE", size))))
    torch.set_num_threads(1)
    path = Path(out_dir) / f"rank{rank}.pkl"
    try:
        from datetime import timedelta

        from qnnpack_tpu_torch.parallel import (distributed_init,
                                                distributed_shutdown)
        distributed_init(f"file://{store}", size, rank, device="cpu",
                         timeout=timedelta(seconds=WORLD_TIMEOUT_S))
        result = globals()[cases](rank, size)
        distributed_shutdown()
    except BaseException:  # noqa: BLE001 - the parent reports it
        path.write_bytes(pickle.dumps({"error": traceback.format_exc()}))
        raise
    path.write_bytes(pickle.dumps(result))


def run_world(size: int, cases: str, tmp_path, env=None,
              timeout: float = WORLD_TIMEOUT_S):
    """Every rank's result of `cases` (a function of this module) in a
    spawned gloo world of `size` processes; raises if a rank failed or the
    world ran past `timeout` seconds (its processes are killed)."""
    out_dir = Path(tmp_path) / f"{cases}_{size}"
    out_dir.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, daemon=True, args=(
        rank, size, str(out_dir / "store"), cases, str(out_dir), env or {}))
        for rank in range(size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join()
    results = []
    for rank, p in enumerate(procs):
        path = out_dir / f"rank{rank}.pkl"
        got = pickle.loads(path.read_bytes()) if path.exists() else {}
        if "error" in got:
            raise RuntimeError(f"rank {rank} of {cases}:\n{got['error']}")
        if late or p.exitcode != 0:
            raise RuntimeError(f"{cases} world of {size}: rank {rank} exit "
                               f"code {p.exitcode}; "
                               f"{len(late)} killed after {timeout} s")
        results.append(got)
    return results
