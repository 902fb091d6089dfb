"""The whole training step's share of the card's peak: the least FLOPs of an
example (its mel, and the VAE's forward and backward counted as three
forwards, ``yardstick.flops.train_example_flops``) times the examples of the
traced window, over the window's time, against the float32 peak outside the
tensor cores (the trunk trains in float32 with TF32 off)."""

from perfbench.yardstick import flops, peaks


def read(r):
    if not r.counts.get("examples") or r.window.seconds <= 0:
        return None
    return 100.0 * r.counts["examples"] * flops.train_example_flops(r.cell.cfg) / r.window.seconds / peaks.FP32_FLOPS
