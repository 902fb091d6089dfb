"""Host time spent waiting for a ring slot's last transfers to finish before
it is written again (the program's ``slot_wait`` spans inside the window, on
any thread: ``HostRing.claim_slot``), a device batch."""


def read(r):
    if r.trace is None or not r.counts.get("batches"):
        return None
    try:
        from anuraxla_torch.utils.timing import spans
    except ImportError:  # a program without spans
        return None
    ms = [(x.end_ns - x.start_ns) * 1e-6 for x in spans(*r.trace.window) or () if x.name == "slot_wait"]
    return sum(ms) / r.counts["batches"] if ms else None
