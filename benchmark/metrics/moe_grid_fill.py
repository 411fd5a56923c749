"""How full the expert layers' worst-case grids are, in %: the rows the
last forward routed to the held experts (the program's device counter
moe.routed_rows, summed over the expert layers) over the rows their
grids are sized for in one forward (the counter moe.grid_rows, held
experts x tokens an expert layer, counted at each graph capture, over
graph.captures).  None where the program has no such counters."""

from benchmark import spans


def read(view):
    routed = spans.counter("moe.routed_rows")
    grid = spans.counter("moe.grid_rows")
    captures = spans.counter("graph.captures")
    if not routed or not grid or not captures:
        return None
    return 100.0 * routed / (grid / captures)
