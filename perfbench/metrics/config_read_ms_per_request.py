"""Host time of reading and parsing ``config.json`` in each request (the
program's ``config_read`` spans inside the window: ``detect_species``'s
``load_config`` + ``read_radial``), a request."""


def read(r):
    if r.trace is None or not r.counts.get("requests"):
        return None
    try:
        from anuraxla_torch.utils.timing import spans
    except ImportError:  # a program without spans
        return None
    ms = [(x.end_ns - x.start_ns) * 1e-6 for x in spans(*r.trace.window) or () if x.name == "config_read"]
    return sum(ms) / r.counts["requests"] if ms else None
