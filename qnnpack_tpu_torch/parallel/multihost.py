"""Multi-host execution on torch.distributed: the world's lifecycle,
hybrid meshes, per-host input feeding and slice-restart recovery (the
counterpart of qnnpack_tpu/parallel/multihost.py).

  1. `distributed_init` - idempotent init_process_group from the variables
     torchrun exports (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, and
     LOCAL_RANK for the card): NCCL for device="cuda", gloo for "cpu".  A
     single process is a no-op that returns False.
  2. `make_hybrid_mesh` - a ("data", "model") mesh whose "model" axis stays
     inside one host (LOCAL_WORLD_SIZE ranks; torchrun numbers ranks host
     by host), so the all-gathers and all-reduces of tensor parallelism
     stay on the host's links and only batch rows cross hosts.
  3. `SliceRecovery` - a host-side snapshot of the packed params and the
     recipe to rebuild device state after a failure: the `on_failure` hook
     of serving.HealthMonitor.

A process with no world (tests, one card) gets a world of itself
(`ensure_world`), so single-process runs share the code path.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device
from ..ops.base import clear_all_graphs
from ..utils.logging import log_error, log_info

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

_INIT_LOCK = threading.Lock()
_INITIALIZED = False


def _env_int(name: str):
    value = os.environ.get(name)
    return int(value) if value else None


def distributed_init(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     *, device="cuda",
                     timeout: timedelta = timedelta(minutes=10)) -> bool:
    """Initialize the multi-process world (idempotent).

    Arguments default to the environment torchrun exports (WORLD_SIZE,
    RANK; MASTER_ADDR and MASTER_PORT through init_method "env://").
    Returns True if a world of more than one process is up, False for the
    single-process no-op.  On the card each rank takes cuda:LOCAL_RANK as
    its current device, before NCCL starts."""
    global _INITIALIZED
    dev = resolve_device(device)
    with _INIT_LOCK:
        if _INITIALIZED:
            return True
        world_size = world_size if world_size is not None else \
            _env_int("WORLD_SIZE")
        rank = rank if rank is not None else _env_int("RANK")
        if init_method is None and world_size in (None, 1):
            log_info("multihost: single-process run, skipping "
                     "init_process_group")
            return False
        if dev.type == "cuda":
            torch.cuda.set_device(_env_int("LOCAL_RANK") or 0)
        dist.init_process_group(BACKENDS[dev.type],
                                init_method=init_method or "env://",
                                world_size=world_size, rank=rank,
                                timeout=timeout)
        _INITIALIZED = True
        log_info("multihost: initialized rank %d/%d (%s)", dist.get_rank(),
                 dist.get_world_size(), BACKENDS[dev.type])
        return True


def distributed_shutdown():
    """Tear the world down (for slice-restart recovery)."""
    global _INITIALIZED
    with _INIT_LOCK:
        if dist.is_initialized():
            dist.destroy_process_group()
        _INITIALIZED = False


def ensure_world(device_type: str) -> int:
    """The world's size, with a world up whose backend serves
    `device_type`: the environment's (distributed_init), else a world of
    this process alone.  Raises if the world up has another backend: a
    CUDA tensor never goes through gloo, nor a CPU one through NCCL."""
    want = BACKENDS[device_type]
    if not dist.is_initialized() and not distributed_init(
            device=device_type):
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
    got = dist.get_backend()
    if got != want:
        raise ValueError(f"a {device_type} mesh needs the {want} backend; "
                         f"the world runs {got}")
    return dist.get_world_size()


def make_hybrid_mesh(n_model: int = 1, *, device="cuda",
                     axis_names=("data", "model")):
    """Mesh with data parallelism across hosts and tensor parallelism
    inside each host.

    `n_model` ranks of one host form the "model" axis; the remaining
    ranks (hosts x ranks per host / n_model) the "data" axis.  With one
    host this is an ordinary mesh of the same logical shape."""
    dev = resolve_device(device)
    world = ensure_world(dev.type)
    local = _env_int("LOCAL_WORLD_SIZE") or world
    if world > local:
        if local % n_model:
            raise ValueError(
                f"n_model={n_model} does not divide the {local} local "
                f"devices of one host; the model axis must stay inside a "
                f"host")
    elif world % n_model:
        raise ValueError(f"{world} devices do not factor into "
                         f"model={n_model}")
    grid = torch.arange(world).reshape(world // n_model, n_model)
    return DeviceMesh(dev.type, grid, mesh_dim_names=tuple(axis_names))


def host_local_batch_to_global(x_local, mesh, batch_axis: str = "data"):
    """This rank's rows of its host's batch, on the mesh's device.

    Each host feeds only its own rows (x_local, a numpy array or tensor of
    the host's batch); the host's ranks split them in data-axis order, so
    batch_sharding(mesh).gather of every rank's rows is the hosts' batches
    in host order, with no rows crossing hosts on the way in."""
    from .mesh import axis_of, mesh_device

    world = dist.get_world_size()
    local = _env_int("LOCAL_WORLD_SIZE") or world
    n_data, index, _ = axis_of(mesh, batch_axis)
    per_host = n_data * local // world
    host_index = index - (dist.get_rank() // local) * per_host
    x = torch.as_tensor(x_local)
    if x.shape[0] % per_host:
        raise ValueError(f"host batch {x.shape[0]} does not divide over "
                         f"{per_host} '{batch_axis}' shards of the host")
    rows = x.shape[0] // per_host
    return x[host_index * rows:(host_index + 1) * rows].contiguous().to(
        mesh_device(mesh))


@dataclasses.dataclass
class SliceRecovery:
    """Failure recovery for a serving deployment.

    Holds a host-side snapshot of the packed params (CPU copies of the
    records' tensors, taken at install time, before any device can fail)
    and the recipe to rebuild device state.  `recover()` is the
    `on_failure` hook for serving.HealthMonitor: it tears down the world,
    initializes it again (after a restart every process comes back and
    meets at the same address), drops every captured CUDA graph, rebuilds
    the mesh and places the snapshot again.

    `place` is a callable (host_params, mesh) -> device_params, typically
    parallel.mesh.shard_params, so recovery reuses the installation
    path."""

    host_params: object
    place: object
    n_model: int = 1
    multi_process: bool = False
    device: str = "cuda"
    recoveries: int = 0
    device_params: object = None
    mesh: object = None

    @classmethod
    def snapshot(cls, params, place, *, n_model: int = 1,
                 multi_process: bool = False,
                 device="cuda") -> "SliceRecovery":
        from .mesh import to_device
        rec = cls(host_params=to_device(params, "cpu"), place=place,
                  n_model=n_model, multi_process=multi_process,
                  device=device)
        rec.install()
        return rec

    def install(self):
        """(Re)build the mesh and place the host snapshot on devices."""
        self.mesh = make_hybrid_mesh(self.n_model, device=self.device)
        self.device_params = self.place(self.host_params, self.mesh)
        return self.device_params

    def recover(self):
        """Full recovery: the world again (multi-process), no graph of the
        failed devices kept, the snapshot placed again."""
        self.recoveries += 1
        log_error("slice recovery #%d: rebuilding device state",
                  self.recoveries)
        if self.multi_process:
            try:
                distributed_shutdown()
            except Exception as exc:  # noqa: BLE001 - old world may be dead
                log_error("shutdown of the failed world raised %s "
                          "(ignored)", exc)
            distributed_init(device=self.device)
        clear_all_graphs()
        return self.install()
