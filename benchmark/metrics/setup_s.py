"""Set-up time: process start to the window's first request or step, with
the kernel build, weight packing, graph captures and warm-up in it."""


def read(view):
    return view.setup_s
