"""Masked attention against its roofline, in %: the roofline bound of the
layers of kinds scores, softmax_masked and context (reference.<config>.
costs: only the pairs of the causal or banded mask, K and V read once a
key/value head) over the device time per forward of the kernels that run
them, q8bmm's masked instance and u8softmax_masked.  None where the trace
holds neither kernel."""

KERNELS = ("q8bmm_masked_kernel", "u8softmax_masked_kernel")
KINDS = ("scores", "softmax_masked", "context")


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
