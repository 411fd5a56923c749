"""The whole forward's share of the card's int8 peak, in %: the int8
operations of one forward counted from the configuration's published
shapes (every conv, FC, linear and attention product, 2 per
multiply-accumulate), times the forwards completed in the traced window,
over its host time and the published peak."""


def read(view):
    if view.peaks is None or view.window.seconds <= 0:
        return None
    ops = sum(c[2] for c in view.costs) * view.window.steps
    return 100.0 * ops / view.window.seconds / view.peaks["int8_ops_per_s"]
