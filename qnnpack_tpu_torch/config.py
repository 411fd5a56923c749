"""Runtime configuration and the device-keyed tuning table.

A port of qnnpack_tpu/config.py, the analogue of the reference's
cpuinfo-driven dispatch (src/init.c:47-242).  The probe is
torch.cuda.get_device_name() on a card and "cpu" when the caller asks for
the CPU; one never stands in for the other.

Left out of TuneParams: the JAX package's Pallas tile shapes and routing
fields (gemm_tile_*, pallas_gemm_*, pallas_small_*, small_tile_m,
grouped_1x1_*, conv_stem_*, dwconv_pallas_*).  They choose between a Pallas
kernel and XLA's lowering on a TPU; every op of the port runs on its CUDA
kernel, whose block shape and split-K kernels/q8gemm.py:tile_plan picks
from the shape and the card's SM count.

Left out with them: the JAX Config record.  Its pallas_mode is a routing
field too; its compilation_cache_dir has nothing to point at, as the port
compiles no program at run time (the kernel library is built once into
kernels/_build.BUILD_DIR, keyed by a hash of its sources); and its
default_requant (QNNPACK_TPU_REQUANT) is read by no code of either
package - the requantization scheme is each builder's or operator's
`requant` argument.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .device import resolve_device
from .utils.logging import log_info


@dataclasses.dataclass(frozen=True)
class TuneParams:
    """Per-device record (the qnnp_params analogue,
    src/qnnpack/params.h:520-538): the peaks that roofline bounds divide
    by, bound = max(bytes / HBM rate, int8 ops / int8 peak)."""

    generation: str
    int8_peak_tops: float = 0.0   # dense int8 tensor-core rate, TOP/s
    hbm_gbps: float = 0.0         # device-memory rate, GB/s


_TUNE_TABLE = {
    # Device name (prefix, lowercase) -> record.  The H100 peaks are
    # NVIDIA's data-sheet values for the SXM part at 700 W (dense int8, no
    # sparsity), not measurements: a card set below 700 W runs slower
    # under load.
    "nvidia h100": TuneParams("h100", int8_peak_tops=1979.0,
                              hbm_gbps=3350.0),
    "cpu": TuneParams("cpu"),
}


@functools.cache
def _probe(device: torch.device) -> TuneParams:
    kind = ("cpu" if device.type == "cpu"
            else torch.cuda.get_device_name(device).lower())
    for prefix, params in _TUNE_TABLE.items():
        if kind.startswith(prefix):
            log_info("tuning for device %r -> %s", kind, params.generation)
            return params
    log_info("unknown device %r; using generic parameters", kind)
    return TuneParams("generic")


def tune_params(device="cuda") -> TuneParams:
    """The tuning record of `device` (the GPU unless the caller asks for the
    CPU; raises when a GPU is asked for and absent)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _probe(dev)


def initialize(device="cuda") -> TuneParams:
    """qnnp_initialize analogue (include/qnnpack.h:34; src/init.c:244-258):
    probes the device and, on a card, builds and loads the kernel library,
    so that no first launch builds it (inside a CUDA-graph capture, for
    one).  Idempotent; returns tune_params(device)."""
    params = tune_params(device)
    if params.generation != "cpu":
        from .kernels import _build
        _build.load_library()
    return params
