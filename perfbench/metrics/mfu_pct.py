"""The whole served step's share of the card's peak: the least FLOPs of a chunk
(mel and encoder, ``yardstick.flops.chunk_flops``) times the chunks of the
traced window, over the window's time, against the dense peak of the
precision the trunk computes in."""

from perfbench.yardstick import flops, peaks


def read(r):
    if not r.counts.get("chunks") or r.window.seconds <= 0:
        return None
    peak = peaks.TRUNK_PEAK[r.cell.workload["session"]["encoder_dtype"]]
    return 100.0 * r.counts["chunks"] * flops.chunk_flops(r.cell.cfg) / r.window.seconds / peak
