"""Samples completed in the window over the window's host time; a closed
loop's window ends with a device synchronize, so every step counted has
finished."""


def read(view):
    return view.window.samples / view.window.seconds
