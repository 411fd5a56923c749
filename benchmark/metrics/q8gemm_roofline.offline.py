"""q8gemm against its roofline, in %: the roofline bound of the layers that
run as GEMMs (1x1 convs, the classifier, BERT's four linears; `gemm` in
reference.<config>.costs) over the device time of the q8gemm kernel in
the traced window per forward."""

KERNELS = ("q8gemm_kernel",)
KINDS = ("gemm",)


def read(view):
    t = view.trace
    if t is None or view.peaks is None or not view.window.steps:
        return None
    kernel_s = sum(t.kernel_s.get(k, 0.0) for k in KERNELS) / view.window.steps
    if kernel_s <= 0:
        return None
    p = view.peaks
    bound = sum(max(ops / p["int8_ops_per_s"], nbytes / p["bytes_per_s"])
                for _, kind, ops, nbytes in view.costs if kind in KINDS)
    return 100.0 * bound / kernel_s
