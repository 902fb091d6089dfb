"""Share of its roofline that the encoder (the kernels launched inside the
program's ``anuraxla::encoder`` span) reaches in the traced window: the
chunks' least FLOPs of the encoder (2 x the family's ``encoder_macs``) at the
dense peak of the precision the trunk computes in, over those kernels' device
time. The bytes bound lies far below (the weights and a chunk's mels, read
once, against 113 GFLOP a chunk in AST's case)."""

from perfbench.yardstick import peaks


def read(r):
    t = r.trace
    if t is None or not r.counts.get("chunks"):
        return None
    ev = t.launched_within("anuraxla::encoder")
    if not ev:
        return None
    cfg = r.cell.cfg
    peak = peaks.TRUNK_PEAK[r.cell.workload["session"]["encoder_dtype"]]
    least = r.counts["chunks"] * 2.0 * r.cell.family.encoder_macs(cfg) / peak
    return 100.0 * least / (sum(e - s for s, e, *_ in ev) * 1e-9)
