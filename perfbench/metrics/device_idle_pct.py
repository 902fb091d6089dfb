"""Share of the traced window in which no kernel, copy or set runs on the card."""


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_ns() * 1e-9 / t.window_s)
