"""Files a second of decode while it runs inside the window: the files of the
program's ``decode`` spans (``load_wav_batch``, on the prefetch thread) over
their summed host time."""


def read(r):
    if r.trace is None:
        return None
    try:
        from anuraxla_torch.utils.timing import spans
    except ImportError:  # a program without spans
        return None
    recs = [x for x in spans(*r.trace.window) or () if x.name == "decode"]
    ns = sum(x.end_ns - x.start_ns for x in recs)
    return sum(x.counts["files"] for x in recs) / (ns * 1e-9) if ns > 0 else None
