"""Encoder variants on the card — the port of ``scripts/probe_encoder.py``:
where the encoder's time a batch goes, and what the whole pipeline gains from
the encoder's compute dtype and norm. At B = 1024 on ``DEFAULT_MEL`` mels
([B, 192, 64, 1]):

    f32            VAEConfig() (GroupNorm, f32 trunk)
    bf16           bfloat16 trunk (params and heads stay f32)
    f32-nonorm     norm="none" (isolates GroupNorm's passes)
    bf16-nonorm    both
    full-bf16enc   rms_scale -> mel kernel (fused scale) -> epilogue -> the
                   bf16-trunk encoder -> radial decide, as the balanced tier

    python -m anuraxla_torch.probes.encoder_variants [--batch 1024] [--measure-s 4]

Prints one JSON line per variant: ``variant``, ``ms_per_batch``,
``chunks_per_s``; the f32 and bf16 variants (the same seeded weights) also
``max_rel_drift_vs_f32``, the largest |mu - mu_f32| on 64 rows over the
largest |mu_f32| (the nonorm variants have other weights: null).
"""

from __future__ import annotations

import dataclasses

import torch

from anuraxla_torch.detect.radial import radial_decide
from anuraxla_torch.models.vae import VAEConfig
from anuraxla_torch.ops.frontend import log_mel_batch, mel_to_encoder_input, rms_scale_batch
from anuraxla_torch.probes.common import (detector_tables, device_header, emit, measure_ms, noise_rows, parser,
                                          seeded_encoder, setup)

VARIANTS = {
    "f32": {},
    "bf16": {"dtype": "bfloat16"},
    "f32-nonorm": {"norm": "none"},
    "bf16-nonorm": {"dtype": "bfloat16", "norm": "none"},
}


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    dev, cfg = setup(args)
    audio = torch.from_numpy(noise_rows(cfg, args.batch, args.seed)).to(dev)
    emit({**device_header(dev), "batch": args.batch, "frames": cfg.total_frames})
    base = VAEConfig(input_hw=(cfg.target_frames, cfg.n_mels))

    with torch.inference_mode():
        x = mel_to_encoder_input(log_mel_batch(audio, cfg, parity=True, backend="cuda"))
        z_ref = None
        for name, knobs in VARIANTS.items():
            enc = seeded_encoder(dataclasses.replace(base, **knobs), dev, args.seed)
            ms = measure_ms(lambda x: enc(x)["mu"], x, args.measure_s, dev)
            drift = None
            if "norm" not in knobs:
                z = enc(x[:64])["mu"].float()
                if z_ref is None:
                    z_ref = z
                drift = float((z - z_ref).abs().max() / z_ref.abs().max().clamp_min(1e-30))
            emit({"variant": name, "ms_per_batch": ms, "chunks_per_s": args.batch / ms * 1e3,
                  "max_rel_drift_vs_f32": drift})

        # the whole pipeline with the bf16-trunk encoder
        vcfg = dataclasses.replace(base, dtype="bfloat16")
        enc = seeded_encoder(vcfg, dev, args.seed)
        centroids, thresholds, ranks = detector_tables(vcfg.latent_dim, dev)

        def full(y):
            mels = log_mel_batch(y, cfg, parity=True, backend="cuda", rms_scale=rms_scale_batch(y))
            return radial_decide(enc(mel_to_encoder_input(mels))["mu"].float(), centroids, thresholds, ranks)

        ms = measure_ms(full, audio, args.measure_s, dev)
        emit({"variant": "full-bf16enc", "ms_per_batch": ms, "chunks_per_s": args.batch / ms * 1e3})


if __name__ == "__main__":
    main()
