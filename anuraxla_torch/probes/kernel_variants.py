"""Sweep of the Cooley–Tukey mel kernel's variants on the card — the port of
``scripts/bench_kernel_variants.py``.

The reference sweeps ``tile_t x row_block x fused``; the first two are
blocking knobs of its compiler with no counterpart here (one CUDA block owns
a row and a frame tile the host picks), so the sweep is ``fused`` in {0, 1} by
mode: the Cooley–Tukey kernel (one product per r, each table stored once)
against the concatenated-operand kernel (``mel_power(fused_dots=True)``), both
on the tensor cores, and with ``--bf16`` their bf16 modes.
``--hop-length 320`` sweeps the hop % 32 family.

    python -m anuraxla_torch.probes.kernel_variants [--batch 1024] [--measure-s 4] [--bf16]

Prints one JSON line per variant: ``fused``, ``exact``, ``ms_per_batch``,
``chunks_per_s`` and ``max_rel_err_vs_baseline``, the largest difference from
the non-fused exact kernel on 16 shared rows, of each row's max. A variant
that fails on the card fails the run.
"""

from __future__ import annotations

import torch

from anuraxla_torch.ops.mel_kernel import mel_power
from anuraxla_torch.probes.common import emit, device_header, max_rel_err, measure_ms, noise_rows, parser, setup


def main(argv=None) -> None:
    p = parser(__doc__)
    p.add_argument("--bf16", action="store_true", help="also run exact=False per variant")
    args = p.parse_args(argv)
    dev, cfg = setup(args)
    T = cfg.total_frames
    audio = torch.from_numpy(noise_rows(cfg, args.batch, args.seed)).to(dev)
    small = audio[:16]
    emit({**device_header(dev), "batch": args.batch, "frames": T, "hop": cfg.hop_length})

    def run(y, fused, exact):
        return mel_power(y, cfg, num_frames=T, exact=exact, algorithm="ct", fused_dots=fused)

    ref = run(small, False, True)
    for fused in (False, True):
        for exact in [True] + ([False] if args.bf16 else []):
            err = max_rel_err(run(small, fused, exact), ref)
            ms = measure_ms(lambda y: run(y, fused, exact), audio, args.measure_s, dev)
            emit({"fused": fused, "exact": exact, "ms_per_batch": ms,
                  "chunks_per_s": args.batch / ms * 1e3, "max_rel_err_vs_baseline": err})


if __name__ == "__main__":
    main()
