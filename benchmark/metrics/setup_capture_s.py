"""Set-up time spent capturing CUDA graphs: the program's spans
graph.capture (initialize, the eager warm-up and its synchronize, the
capture and the graph's instantiation), less the library load nested in
them, which setup_library_s counts, from the recorder of a --trace 1
run."""

from benchmark import spans


def read(view):
    return spans.setup_parts()["setup_capture_s"]
