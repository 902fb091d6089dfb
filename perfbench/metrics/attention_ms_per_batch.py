"""Device time of the kernels launched inside the program's ``attention`` spans
(the ``anuraxla::attention`` range the AST encoder opens around each block's
attention core), a device batch."""


def read(r):
    t = r.trace
    if t is None or not r.counts.get("batches"):
        return None
    ev = t.launched_within("anuraxla::attention")
    return sum(e - s for s, e, *_ in ev) * 1e-6 / r.counts["batches"] if ev else None
