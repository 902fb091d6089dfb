"""Host time of the synchronizing device-to-host reads of results (the
program's ``fetch`` spans inside the window: the latents of each batch, the
scan's decisions, the folder's decide), a device batch."""


def read(r):
    if r.trace is None or not r.counts.get("batches"):
        return None
    try:
        from anuraxla_torch.utils.timing import spans
    except ImportError:  # a program without spans
        return None
    ms = [(x.end_ns - x.start_ns) * 1e-6 for x in spans(*r.trace.window) or () if x.name == "fetch"]
    return sum(ms) / r.counts["batches"] if ms else None
