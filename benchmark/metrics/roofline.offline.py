"""The forward's kernels against their roofline, in %: the sum over the
model's layers of max(int8 operations / peak rate, bytes / peak bandwidth)
(reference.<config>.costs: each input, weight and output byte once), over
the device time of every kernel in the traced window per forward.  The
work is counted from the model, not from the kernels that run it."""


def read(view):
    t = view.trace
    if t is None or view.peaks is None or not view.window.steps:
        return None
    kernel_s = sum(t.kernel_s.values()) / view.window.steps
    if kernel_s <= 0:
        return None
    p = view.peaks
    bound = sum(max(ops / p["int8_ops_per_s"], nbytes / p["bytes_per_s"])
                for _, _, ops, nbytes in view.costs)
    return 100.0 * bound / kernel_s
