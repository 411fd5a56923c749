"""CUDA graphs captured over the whole run: the program's counter
graph.captures.  An offline run captures once, in set-up; more means a
graph was built again."""

from benchmark import spans


def read(view):
    return spans.counter("graph.captures")
