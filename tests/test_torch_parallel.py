"""The port's mesh layer (qnnpack_tpu_torch.parallel.mesh) against the JAX
package's on the 8-device virtual CPU mesh: DP, TP and DP x TP execution
of the tiny MobileNetV2 of tests/test_parallel.py in a spawned world of
eight gloo ranks (tests/torch_parallel_worlds.py) must give the bytes of
the JAX sharded forward on every rank; so must ColumnShard on per-channel
records of each layout against the JAX unsharded q8gemm / q8conv2d.  A
one-rank world in this process checks the backend rules: a CUDA mesh
needs a GPU and the NCCL backend, and no collective takes a tensor of
another device type."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_worlds as W
from qnnpack_tpu.models.mobilenet_v2 import (build_mobilenet_v2,
                                             mobilenet_v2_forward)
from qnnpack_tpu.nn.conv import pack_conv_weights as jpack_conv
from qnnpack_tpu.nn.conv import q8conv2d as jq8conv2d
from qnnpack_tpu.nn.gemm import q8gemm as jq8gemm
from qnnpack_tpu.nn.packing import pack_gemm_weights as jpack_gemm
from qnnpack_tpu.parallel import (batch_sharding, make_mesh, shard_params,
                                  sharded_inference_fn)
from qnnpack_tpu.parallel.mesh import _shardable
from qnnpack_tpu.quant.params import compute_per_channel_fp32_params
from qnnpack_tpu_torch import parallel as tparallel
from qnnpack_tpu_torch.nn import shard as tshard
from qnnpack_tpu_torch.parallel import multihost as tmultihost

requires_8_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.run_world(8, "cases_mobilenet", tmp_path_factory.mktemp("w8"))


def _same_on_every_rank(world, key, want):
    for rank, got in enumerate(world):
        np.testing.assert_array_equal(got[key], want,
                                      err_msg=f"{key}, rank {rank}")


@requires_8_devices
@pytest.mark.parametrize("n_data,n_model", W.MESH_SHAPES)
def test_sharded_matches_jax_sharded(world, n_data, n_model):
    params, spec, x = W.tiny_mobilenet(build_mobilenet_v2, 21)
    mesh = make_mesh(n_data, n_model)
    fwd = sharded_inference_fn(
        lambda p, v: mobilenet_v2_forward(p, spec, v), mesh)
    want = np.asarray(fwd(shard_params(params, mesh), jax.device_put(
        jnp.asarray(x), batch_sharding(mesh))))
    _same_on_every_rank(world, f"mobilenet {n_data}x{n_model}", want)
    shards = sum(_shardable(p, mesh) for p in params if p is not None)
    assert world[0][f"column shards {n_data}x{n_model}"] == shards


@requires_8_devices
def test_mesh_shapes(world):
    mesh = make_mesh(4, 2)
    names, shape = world[0]["mesh shape"]
    assert dict(zip(names, shape)) == dict(mesh.shape)
    with pytest.raises(AssertionError, match="do not factor"):
        make_mesh(3, 2)
    kind, name, msg = world[0]["mesh 3x2"]
    assert (kind, name) == ("raised", "AssertionError")
    assert "do not factor" in msg


@pytest.mark.parametrize("layout", ["gemm", "dense", "grouped", "depthwise"])
def test_column_shards_with_per_channel_scales(world, layout):
    """Eight ranks' output-channel slices, each requantized with its own
    columns of the scales, gathered: the JAX unsharded result."""
    d = W.column_inputs()
    a = jnp.asarray(d["a"])
    if layout == "gemm":
        w, b, s = d["gemm"]
        rp = compute_per_channel_fp32_params(s, 117)
        want = jq8gemm(a.reshape(-1, 16), jpack_gemm(w, b, 121, 103),
                       rp).reshape(2, 6, 6, -1)
    else:
        k, b, s, groups = d[layout]
        rp = compute_per_channel_fp32_params(s, 117)
        want = jq8conv2d(a, jpack_conv(k, b, 121, 103, groups=groups), rp,
                         padding=((1, 1), (1, 1)))
    _same_on_every_rank(world, f"columns {layout}", np.asarray(want))


@pytest.fixture
def one_rank_world():
    """A world of this process alone (gloo), torn down afterwards."""
    yield tparallel.make_mesh(1, 1, device="cpu")
    tparallel.distributed_shutdown()


def test_one_rank_mesh_keeps_records_whole(one_rank_world):
    mesh = one_rank_world
    assert tuple(mesh.shape) == (1, 1)
    params, spec, x = W.tiny_mobilenet(W._build_mobilenet(
        W._port()["mv2"]), 21)
    sharded = tparallel.shard_params(params, mesh)
    assert all(s is p for s, p in zip(sharded, params))
    bs = tparallel.batch_sharding(mesh)
    xt = torch.from_numpy(x)
    torch.testing.assert_close(bs.gather(bs.shard(xt)), xt, rtol=0, atol=0)


def test_cuda_mesh_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tparallel.make_mesh(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tparallel.make_hybrid_mesh(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tparallel.distributed_init(device="cuda")


def test_a_gloo_world_serves_no_cuda_mesh(one_rank_world):
    with pytest.raises(ValueError, match="needs the nccl backend"):
        tmultihost.ensure_world("cuda")


def test_collectives_refuse_another_device_type(one_rank_world):
    """A tensor of another device type than the mesh's never reaches a
    collective (here a meta tensor on the gloo mesh, as a CUDA tensor on
    it would be)."""
    mesh = one_rank_world
    y = torch.empty((2, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="a meta tensor on a cpu mesh"):
        tparallel.batch_sharding(mesh).gather(y)
    with pytest.raises(ValueError, match="a meta tensor on a cpu mesh"):
        tparallel.sharded_inference_fn(lambda p, v: v, mesh)(None, y)
    shard = tshard.ColumnShard(None, 4, 1, 0, mesh.get_group("model"), "cpu")
    with pytest.raises(ValueError, match="a meta tensor on a cpu mesh"):
        shard.gather(y)
    with pytest.raises(ValueError, match="a meta tensor on a cpu mesh"):
        tparallel.mesh.all_reduce_int32(y.to(torch.int32), mesh, "model")
