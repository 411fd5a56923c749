"""Set-up time spent finding, building and loading the CUDA kernel
library and binding its signatures: the program's span library.load, its
nvcc build (library.build) included, from the recorder of a --trace 1
run."""

from benchmark import spans


def read(view):
    return spans.setup_parts()["setup_library_s"]
