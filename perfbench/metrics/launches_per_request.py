"""Kernels launched on the card a request, in the traced window."""


def read(r):
    t = r.trace
    if t is None or not r.counts.get("requests"):
        return None
    n = len(t.kernels())
    return n / r.counts["requests"] if n else None
