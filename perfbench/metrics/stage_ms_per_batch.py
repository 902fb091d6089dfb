"""Host time of copying rows that are not yet in a ring slot into one before
their transfer (the program's ``stage`` spans inside the window:
``EncoderSession._to_slot``), a device batch."""


def read(r):
    if r.trace is None or not r.counts.get("batches"):
        return None
    try:
        from anuraxla_torch.utils.timing import spans
    except ImportError:  # a program without spans
        return None
    ms = [(x.end_ns - x.start_ns) * 1e-6 for x in spans(*r.trace.window) or () if x.name == "stage"]
    return sum(ms) / r.counts["batches"] if ms else None
