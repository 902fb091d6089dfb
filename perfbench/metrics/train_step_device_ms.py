"""Device time of the kernels an update launches (all kernels of the traced
window but those launched inside the mel stream's ``log_mel_batch``), a step."""


def read(r):
    t = r.trace
    if t is None or not r.counts.get("steps"):
        return None
    mel = {id(d) for d in t.launched_within("perfbench::mel")}
    ev = [d for d in t.kernels() if id(d) not in mel]
    return sum(e - s for s, e, *_ in ev) * 1e-6 / r.counts["steps"] if ev else None
