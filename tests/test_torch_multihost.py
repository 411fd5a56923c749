"""The port's multi-host module (qnnpack_tpu_torch.parallel.multihost)
against the JAX package's (the cases of tests/test_multihost.py).

A spawned world of eight gloo ranks in two "hosts" of four
(LOCAL_WORLD_SIZE 4; tests/torch_parallel_worlds.py) runs the
multi-process branch: distributed_init is up (and idempotent), hybrid
meshes keep the "model" axis inside a host and refuse a factor that would
cross one, each host feeds its own rows through
host_local_batch_to_global, the TP x DP MobileNetV2 forward from the two
hosts' rows equals the JAX single-process forward, and SliceRecovery
restores the sharded forward after the device state is dropped, also as
HealthMonitor's on_failure hook.  In this process: distributed_init is a
no-op for one process, and a mesh of a world of one refuses a model axis
it cannot hold."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_parallel_worlds as W
from qnnpack_tpu.models.mobilenet_v2 import (build_mobilenet_v2,
                                             mobilenet_v2_forward)
from qnnpack_tpu.parallel import (SliceRecovery, batch_sharding,
                                  host_local_batch_to_global,
                                  make_hybrid_mesh, shard_params,
                                  sharded_inference_fn)
from qnnpack_tpu_torch import parallel as tparallel

requires_8_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.run_world(8, "cases_multihost", tmp_path_factory.mktemp("w8"),
                       env={"LOCAL_WORLD_SIZE": "4"})


def test_distributed_init_single_process_noop(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert tparallel.distributed_init(device="cpu") is False
    assert tparallel.distributed_init(world_size=1, device="cpu") is False


def test_distributed_init_is_idempotent_in_a_world(world):
    assert all(r["init again"] is True for r in world)


@requires_8_devices
@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_hybrid_mesh_keeps_the_model_axis_in_a_host(world, n_model):
    mesh = make_hybrid_mesh(n_model)
    for r in world:
        names, shape, grid = r[f"hybrid {n_model}"]
        assert names == mesh.axis_names
        assert dict(zip(names, shape)) == dict(mesh.shape)
        for row in grid:  # ranks 0-3 are host 0, ranks 4-7 host 1
            assert len({rank // 4 for rank in row}) == 1


@pytest.mark.parametrize("n_model", [3, 8])
def test_hybrid_mesh_rejects_a_model_axis_across_hosts(world, n_model):
    for r in world:
        kind, name, msg = r[f"hybrid {n_model}"]
        assert (kind, name) == ("raised", "ValueError")
        assert "must stay inside a host" in msg


def test_hybrid_mesh_rejects_bad_factor():
    with pytest.raises(ValueError):
        make_hybrid_mesh(3)
    try:
        with pytest.raises(ValueError, match="do not factor"):
            tparallel.make_hybrid_mesh(3, device="cpu")
    finally:
        tparallel.distributed_shutdown()


@requires_8_devices
def test_host_local_batches_to_global(world):
    """Each host's rows land on its own ranks, two rows a rank; gathered,
    they are the hosts' batches in host order, as JAX assembles them."""
    batches = W.host_batches()
    want = np.asarray(jax.device_get(host_local_batch_to_global(
        np.concatenate(batches), make_hybrid_mesh(2))))
    for rank, r in enumerate(world):
        np.testing.assert_array_equal(r["host batch"], want)
        data = rank // 2  # the (4, 2) mesh's data coordinate
        np.testing.assert_array_equal(r["host rows"],
                                      want[4 * data:4 * data + 4])


@requires_8_devices
def test_two_host_sharded_forward_matches_jax(world):
    """TP (model axis inside each host) x DP (across hosts) MobileNetV2
    from per-host rows == the JAX single-process forward."""
    params, spec, x = W.tiny_mobilenet(build_mobilenet_v2, 9)
    want = np.asarray(jax.jit(
        lambda p, v: mobilenet_v2_forward(p, spec, v))(params,
                                                       jnp.asarray(x)))
    for r in world:
        np.testing.assert_array_equal(r["two hosts"], want)


@requires_8_devices
def test_slice_recovery_round_trip(world):
    params, spec, x = W.tiny_mobilenet(build_mobilenet_v2, 9)
    rec = SliceRecovery.snapshot(params, shard_params, n_model=2)
    fwd = sharded_inference_fn(
        lambda p, v: mobilenet_v2_forward(p, spec, v), rec.mesh)
    want = np.asarray(jax.device_get(fwd(rec.device_params, jax.device_put(
        jnp.asarray(x), batch_sharding(rec.mesh)))))
    for r in world:
        recoveries, before, after = r["recovery"]
        assert recoveries == 1
        np.testing.assert_array_equal(before, want)
        np.testing.assert_array_equal(after, want)


def test_health_monitor_triggers_recovery(world):
    """HealthMonitor(deadline_s=-1).probe_once() fails, calls
    SliceRecovery.recover, and the params come back."""
    w = W.case_rng("monitor").integers(0, 255, (4, 4),
                                       dtype=np.int64).astype(np.uint8)
    for r in world:
        ok, healthy, recoveries, got = r["monitor"]
        assert (ok, healthy, recoveries) == (False, False, 1)
        np.testing.assert_array_equal(got, w)
