"""Host time a request waits for its latents to come back from the device
(the program's ``fetch`` spans inside a ``request`` span, in the window), a
request."""


def read(r):
    if r.trace is None or not r.counts.get("requests"):
        return None
    try:
        from anuraxla_torch.utils.timing import spans
    except ImportError:  # a program without spans
        return None
    recs = spans(*r.trace.window) or []
    by_seq = {x.seq: x for x in recs}

    def in_request(x):
        while x.parent is not None:
            x = by_seq.get(x.parent)
            if x is None:
                return False
            if x.name == "request":
                return True
        return False

    ms = [(x.end_ns - x.start_ns) * 1e-6 for x in recs if x.name == "fetch" and in_request(x)]
    return sum(ms) / r.counts["requests"] if ms else None
