"""Requests answered over all the time of the window: one client's closed loop
keeps the server busy throughout, so this is the rate the path sustains."""


def read(r):
    return r.window.units / r.window.seconds if r.window.seconds > 0 and r.window.units else None
