"""Share of its roofline that the Cooley-Tukey mel kernel (kernels named
``mel_power_ct*``) reaches in the traced window: the least time of the chunks'
mel (least FLOPs at the bf16 tensor-core peak, or the row read once and the
mel power written once at the HBM rate, whichever is longer) over the
kernels' device time."""

from perfbench.yardstick import flops, peaks


def read(r):
    t = r.trace
    if t is None or not r.counts.get("chunks"):
        return None
    ev = [d for d in t.kernels() if "mel_power_ct" in d[2]]
    if not ev:
        return None
    mel = r.cell.cfg["mel"]
    least = r.counts["chunks"] * max(flops.mel_flops_per_row(mel) / peaks.BF16_FLOPS,
                                     flops.mel_bytes_per_row(mel) / peaks.HBM_BYTES_PER_S)
    return 100.0 * least / (sum(e - s for s, e, *_ in ev) * 1e-9)
