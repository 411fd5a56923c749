"""The expert layer's and attention's small kernels against their
roofline, in %: the bound of the layers of kinds rope, route, swiglu and
combine (reference.<config>.costs; all bound by bytes) over the device
time per forward of q8rope, moe_route's two kernels, q8swiglu and
moe_combine.  None where the trace holds none of them."""

KERNELS = ("q8rope_kernel", "moe_route_kernel", "moe_dispatch_kernel",
           "q8swiglu_kernel", "moe_combine_kernel")
KINDS = ("rope", "route", "swiglu", "combine")


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
