"""Share of its roofline that the attention core (the kernels launched inside
the program's ``anuraxla::attention`` spans) reaches in the traced window:
the chunks' least time of the core (``yardstick/ast.py``: Q Kᵀ and P V at the
bf16 tensor-core peak, or Q, K, V read once and O written once in bf16 at the
HBM rate, whichever is longer) over those kernels' device time."""

from perfbench.yardstick import ast as yardstick
from perfbench.yardstick import peaks


def read(r):
    t = r.trace
    if t is None or not r.counts.get("chunks"):
        return None
    ev = t.launched_within("anuraxla::attention")
    if not ev:
        return None
    cfg = r.cell.cfg
    least = r.counts["chunks"] * max(yardstick.attention_flops(cfg) / peaks.BF16_FLOPS,
                                     yardstick.attention_bytes(cfg) / peaks.HBM_BYTES_PER_S)
    return 100.0 * least / (sum(e - s for s, e, *_ in ev) * 1e-9)
