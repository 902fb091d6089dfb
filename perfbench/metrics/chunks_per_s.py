"""Chunks whose decision reached the host, over all the time of the window's whole passes."""


def read(r):
    return r.window.units / r.window.seconds if r.window.seconds > 0 and r.window.units else None
