"""What the program's own recorder of spans and counters
(qnnpack_tpu_torch.utils.profiling) holds in this process, for the
per-layer metrics that read it.  The recorder aggregates over the whole
run, set-up and window.  Where the program has no such recorder, or it
recorded nothing under a name, these give None."""

from __future__ import annotations


def _recorder():
    try:
        from qnnpack_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "span_total") else None


def span(name: str, less: tuple = ()):
    """(calls, seconds) of the spans `name`, less the spans named in `less`
    nested in them (profiling.span_total), or None."""
    rec = _recorder()
    return None if rec is None else rec.span_total(name, less)


def seconds(name: str, less: tuple = ()):
    got = span(name, less)
    return None if got is None else got[1]


def self_seconds(name: str):
    """Seconds of the spans `name` outside their child spans (the self
    time of every path that ends in `name`), or None."""
    rec = _recorder()
    if rec is None:
        return None
    got = [t.self_s for path, t in rec.totals().items()
           if path.split("/")[-1] == name]
    return sum(got) if got else None


def counter(name: str):
    rec = _recorder()
    return None if rec is None else rec.counters().get(name)


def setup_parts() -> dict:
    """The set-up metrics' spans: the kernel library, weight packing and
    graph capture, each without the library load nested in it, so no
    second is counted twice."""
    return {"setup_library_s": seconds("library.load"),
            "setup_pack_s": seconds("setup.pack", ("library.load",)),
            "setup_capture_s": seconds("graph.capture", ("library.load",))}
