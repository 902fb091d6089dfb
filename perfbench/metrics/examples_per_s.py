"""Training examples stepped over all the time of the window's calls, the input pipeline included."""


def read(r):
    return r.window.units / r.window.seconds if r.window.seconds > 0 and r.window.units else None
