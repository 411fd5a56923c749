"""Set-up time outside the program's set-up spans: setup_s less
setup_library_s, setup_pack_s and setup_capture_s.  It holds the
interpreter and its imports, the CUDA context, and the benchmark's own
draws of weights and inputs.  Read in the --trace 1 run, whose setup_s
the harness takes after the profiler has started, so it holds the
profiler's start too (about 5 s on an H100 host) and reads above the
untraced runs' setup_s."""

from benchmark import spans


def read(view):
    parts = spans.setup_parts().values()
    if any(p is None for p in parts):
        return None
    return view.setup_s - sum(parts)
