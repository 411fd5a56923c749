"""The held experts' grouped GEMMs against their roofline, in %: the bound
of the layers of kind expert_gemm (reference.<config>.costs, counted at
the rows the routing is expected to give each layer) with their
operations scaled to the rows the last forward routed to the held
experts (the program's device counter moe.routed_rows, over every expert
layer), over the device time per forward of q8gemm's grouped instance.
The bytes are the expected rows' (the weights, the most of them, do not
change).  The counter holds the last replayed forward's routing only, so
with a ring of two batches the reading is scaled to whichever batch ran
last, not to the window's mean.  None where the trace holds no grouped
launch or the program has no such counter."""

from benchmark import spans

KERNELS = ("q8gemm_grouped_kernel",)
KIND = "expert_gemm"


def read(view):
    t = view.trace
    if t is None or view.peaks is None or not view.window.steps:
        return None
    kernel_s = sum(t.kernel_s.get(k, 0.0) for k in KERNELS) / view.window.steps
    routed = spans.counter("moe.routed_rows")
    layers = [c for c in view.costs if c[1] == KIND]
    if kernel_s <= 0 or not routed or not layers:
        return None
    cfg = view.cell.cfg
    expected = (view.batch * cfg["seq_len"] * cfg["num_experts_per_tok"]
                * cfg["n_routed_experts"] / cfg["router_experts"])
    scale = routed / (expected * len(layers) / 2)   # two GEMMs a layer
    p = view.peaks
    bound = sum(max(ops * scale / p["int8_ops_per_s"],
                    nbytes / p["bytes_per_s"])
                for _, _, ops, nbytes in layers)
    return 100.0 * bound / kernel_s
