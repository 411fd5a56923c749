"""Set-up time spent packing the weights: the program's spans setup.pack,
one a packed record (the host time of its conversions and launches), less
a library load nested in them, from the recorder of a --trace 1 run."""

from benchmark import spans


def read(view):
    return spans.setup_parts()["setup_pack_s"]
