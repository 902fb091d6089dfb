"""Device time of the kernels launched inside the encoder module's forward
(the ``perfbench::encoder`` range the harness opens around it), a device batch."""


def read(r):
    t = r.trace
    if t is None or not r.counts.get("batches"):
        return None
    ev = t.launched_within("perfbench::encoder")
    return sum(e - s for s, e, *_ in ev) * 1e-6 / r.counts["batches"] if ev else None
