"""Stage split of the parity pipeline on the card — the port of
``scripts/profile_stages.py``. Times, in one process, each stage of the
served path on a device-resident batch:

    full      rms_scale -> mel kernel (fused scale) -> dB/standardize/crop ->
              encoder -> radial detect
    melpow    rms_scale + the fused-scale mel power kernel only
    frontend  melpow + the dB/standardize/crop epilogue (log_mel_batch)
    encoder   conv-VAE encode of a precomputed mel batch
    detect    radial decide on a precomputed latent batch

    python -m anuraxla_torch.probes.profile_stages [--batch 1024] [--measure-s 4]

Prints one JSON line per stage: ``stage``, ``ms_per_batch``, ``chunks_per_s``.
"""

from __future__ import annotations

import dataclasses

import torch

from anuraxla_torch.detect.radial import radial_decide
from anuraxla_torch.models.vae import VAEConfig
from anuraxla_torch.ops.frontend import log_mel_batch, mel_to_encoder_input, rms_scale_batch
from anuraxla_torch.ops.mel_kernel import mel_power
from anuraxla_torch.probes.common import (detector_tables, device_header, emit, measure_ms, noise_rows, parser,
                                          seeded_encoder, setup)


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    dev, cfg = setup(args)
    audio = torch.from_numpy(noise_rows(cfg, args.batch, args.seed)).to(dev)
    emit({**device_header(dev), "batch": args.batch, "frames": cfg.total_frames})

    vcfg = dataclasses.replace(VAEConfig(), input_hw=(cfg.target_frames, cfg.n_mels))
    enc = seeded_encoder(vcfg, dev)
    centroids, thresholds, ranks = detector_tables(vcfg.latent_dim, dev)

    def frontend(y):
        return log_mel_batch(y, cfg, parity=True, backend="cuda", rms_scale=rms_scale_batch(y))

    def melpow(y):
        return mel_power(y, cfg, num_frames=cfg.total_frames, exact=True, algorithm="ct",
                         rms_scale=rms_scale_batch(y))

    def encoder(x):
        return enc(x)["mu"]

    def detect(z):
        return radial_decide(z, centroids, thresholds, ranks)

    def full(y):
        return detect(encoder(mel_to_encoder_input(frontend(y))))

    with torch.inference_mode():
        x_const = mel_to_encoder_input(log_mel_batch(audio, cfg, parity=True, backend="cuda"))
        z_const = encoder(x_const)
        for name, fn, arg in (("full", full, audio), ("melpow", melpow, audio), ("frontend", frontend, audio),
                              ("encoder", encoder, x_const), ("detect", detect, z_const)):
            ms = measure_ms(fn, arg, args.measure_s, dev)
            emit({"stage": name, "ms_per_batch": ms, "chunks_per_s": args.batch / ms * 1e3})


if __name__ == "__main__":
    main()
