"""Host time of one call that replays a captured graph, in us, outside
the two launches that wait while the card's launch queue is full: the
key walk over the parameters (span runtime.key), the call's own work (the
self time of runtime.call: its lock, the stream's wait on the last
replay, the event it records) and the output clone (runtime.clone_out),
over the calls of runtime.call, from the recorder of a --trace 1 run.
The input copy (runtime.copy_in) and graph.replay() (runtime.replay) are
left out: where the host runs ahead of the card, one of them blocks until
the queue has room, for about a device step.  The program records these
spans only while a profiler is on, so they cover the traced window's
calls alone; the profiler's own callbacks lengthen the key walk and the
clone there."""

from benchmark import spans


def read(view):
    got = spans.span("runtime.call")
    if got is None or not got[0]:
        return None
    parts = (spans.seconds("runtime.key"), spans.self_seconds("runtime.call"),
             spans.seconds("runtime.clone_out"))
    if any(p is None for p in parts):
        return None
    return 1e6 * sum(parts) / got[0]
