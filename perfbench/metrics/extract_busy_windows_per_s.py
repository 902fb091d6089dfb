"""Windows a second of extraction while it runs inside the window: the
windows of the program's ``extract`` spans (``fleet_window_batches``, on the
prefetch thread) over their summed host time."""


def read(r):
    if r.trace is None:
        return None
    try:
        from anuraxla_torch.utils.timing import spans
    except ImportError:  # a program without spans
        return None
    recs = [x for x in spans(*r.trace.window) or () if x.name == "extract"]
    ns = sum(x.end_ns - x.start_ns for x in recs)
    return sum(x.counts["windows"] for x in recs) / (ns * 1e-9) if ns > 0 else None
