"""Share of the traced window with no kernel, copy or fill on the card,
in % (torch.profiler's device events, their union over the window)."""


def read(view):
    t = view.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
