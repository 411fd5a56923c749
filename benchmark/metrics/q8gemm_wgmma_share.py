"""q8gemm's launches that took its wgmma instance, in %: the program's
counter q8gemm.wgmma over its counter q8gemm.launches
(qnnpack_tpu_torch/kernels/q8gemm.py), both counted at each launch over
the whole run, so at the eager warm-up and the capture, and never at a
replay.  None where the program counted no q8gemm launch, or has no such
counters."""

from benchmark import spans


def read(view):
    launches = spans.counter("q8gemm.launches")
    if not launches:
        return None
    return 100.0 * (spans.counter("q8gemm.wgmma") or 0) / launches
