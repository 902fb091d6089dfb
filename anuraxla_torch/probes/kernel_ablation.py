"""Op-class cost study of the Cooley–Tukey mel kernel on the card — the port
of ``scripts/probe_kernel_ablation.py``.

No kernel profiler runs where this card is, so the cost of a class of work is
measured as the time that goes when the class is dropped:
``mel_power(ablate=...)`` (PROFILING ONLY — wrong output) times the kernel
with ONE class removed at a time, each a delta against the intact kernel in
the same process. Classes: window (Hann multiply), inner (inner-DFT
combines), power (square-add), fb (filterbank product), and in the exact mode
splits (the bf16 hi/lo splits: lo = -hi) and dots (one tensor-core pass per
product instead of three); ``floor`` drops every class of the mode and leaves
staging plus one pass of the outer products. The reference's shifts class has
no counterpart in this kernel and is refused by ``mel_power``. The intact
kernel is measured first and last; the spread of that bracket is the drift a
delta has to beat.

    python -m anuraxla_torch.probes.kernel_ablation [--batch 1024] [--measure-s 4] [--bf16]

Prints one JSON line per variant (``variant``, ``ms_per_batch``), then the
bracket and, per class, ``delta_ms_vs_baseline`` and ``pct_of_baseline``.
"""

from __future__ import annotations

import torch

from anuraxla_torch.ops.mel_kernel import ABLATE_CLASSES, EXACT_ONLY_CLASSES, ablate_library, ablate_mask, mel_power
from anuraxla_torch.probes.common import device_header, emit, measure_ms, noise_rows, parser, pre_padded_rows, setup


def variants(exact: bool) -> list:
    """(name, ablate) of each timed variant in the mode: every class alone,
    all of them (the floor), and the intact kernel first and last."""
    classes = tuple(c for c in ABLATE_CLASSES if exact or c not in EXACT_ONLY_CLASSES)
    return [("baseline", ())] + [(f"no-{cls}", (cls,)) for cls in classes] + [("floor", classes),
                                                                              ("baseline-close", ())]


def main(argv=None) -> None:
    p = parser(__doc__)
    p.add_argument("--bf16", action="store_true", help="exact=False variants")
    args = p.parse_args(argv)
    dev, cfg = setup(args)
    T = cfg.total_frames
    exact = not args.bf16
    timed = variants(exact)
    rows, _ = pre_padded_rows(cfg, noise_rows(cfg, args.batch, args.seed))
    y = torch.from_numpy(rows).to(dev)
    emit({**device_header(dev), "batch": args.batch, "frames": T, "exact": exact, "pre_padded": True})
    if dev.type == "cuda":  # the ablated libraries, one nvcc each, all started together
        from anuraxla_torch.ops import _build

        _build.build([ablate_library(ablate_mask(ablate, exact=exact)) for _, ablate in timed if ablate])

    measured = []
    for name, ablate in timed:
        ms = measure_ms(lambda y: mel_power(y, cfg, num_frames=T, exact=exact, algorithm="ct",
                                            pre_padded=True, ablate=ablate), y, args.measure_s, dev)
        measured.append((name, ms))
        emit({"variant": name, "ms_per_batch": ms})

    base = [ms for name, ms in measured if name.startswith("baseline")]
    mean = sum(base) / len(base)
    emit({"baseline_bracket_ms": base})
    for name, ms in measured:
        if not name.startswith("baseline"):
            emit({"variant": name, "delta_ms_vs_baseline": mean - ms, "pct_of_baseline": (mean - ms) / mean * 100})


if __name__ == "__main__":
    main()
