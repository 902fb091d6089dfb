"""The mel kernel's variants under the pre-padded regime — the port of
``scripts/probe_phase_variants.py``: rows in the ``phase_padded_layout``, the
RMS scale reduced over the sliced valid region and fused into the kernel,
``fused_dots`` off and on. (The reference also sweeps ``row_block``, a
blocking knob with no counterpart here.)

    python -m anuraxla_torch.probes.phase_variants [--batch 1024] [--measure-s 4]

Prints one JSON line per variant: ``variant``, ``ms_per_batch``,
``chunks_per_s`` and ``max_rel_err_vs_first``, the largest difference from the
first variant on 16 rows without the scale, of each row's max.
"""

from __future__ import annotations

import torch

from anuraxla_torch.ops.frontend import rms_scale_batch
from anuraxla_torch.ops.mel_kernel import mel_power
from anuraxla_torch.probes.common import (device_header, emit, max_rel_err, measure_ms, noise_rows, parser,
                                          pre_padded_rows, setup)


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    dev, cfg = setup(args)
    T = cfg.total_frames
    rows, pad_l = pre_padded_rows(cfg, noise_rows(cfg, args.batch, args.seed))
    y = torch.from_numpy(rows).to(dev)
    emit({**device_header(dev), "batch": args.batch, "frames": T, "pre_padded": True})

    ref = None
    for fused in (False, True):
        def melpow(y, fused=fused):
            scale = rms_scale_batch(y[:, pad_l : pad_l + cfg.num_samples])
            return mel_power(y, cfg, num_frames=T, exact=True, algorithm="ct", rms_scale=scale,
                             pre_padded=True, fused_dots=fused)

        small = mel_power(y[:16], cfg, num_frames=T, exact=True, algorithm="ct", pre_padded=True, fused_dots=fused)
        if ref is None:
            ref = small
        ms = measure_ms(melpow, y, args.measure_s, dev)
        emit({"variant": f"fused={fused}", "ms_per_batch": ms, "chunks_per_s": args.batch / ms * 1e3,
              "max_rel_err_vs_first": max_rel_err(small, ref)})


if __name__ == "__main__":
    main()
