"""Host time the consumer waits on the prefetch thread for its next batch (the
program's ``input_wait`` spans inside the window: ``fut.result()`` in
``iter_batches`` and ``fleet_window_batches``), a device batch."""


def read(r):
    if r.trace is None or not r.counts.get("batches"):
        return None
    try:
        from anuraxla_torch.utils.timing import spans
    except ImportError:  # a program without spans
        return None
    ms = [(x.end_ns - x.start_ns) * 1e-6 for x in spans(*r.trace.window) or () if x.name == "input_wait"]
    return sum(ms) / r.counts["batches"] if ms else None
