"""Device time of the kernels launched inside the program's own encoder span
(the ``anuraxla::encoder`` range ``EncoderSession._forward`` opens around the
encoder call), a device batch."""


def read(r):
    t = r.trace
    if t is None or not r.counts.get("batches"):
        return None
    ev = t.launched_within("anuraxla::encoder")
    return sum(e - s for s, e, *_ in ev) * 1e-6 / r.counts["batches"] if ev else None
