"""``ingest-decoder`` on the port — ``anuraxla/cli/ingest_decoder.py``:
convert a reference-style torch *decoder* artifact into a decoder artifact
(``decoder.msgpack`` + ``decoder.json``, the JAX package's format, written by
``models.checkpoint.save_decoder``).

The reference's thesis baseline ships a decoder checkpoint next to the
encoder (``ref:docs/REPRODUCE_THESIS_BASELINE.md:33-42`` —
``bird_net_vae_audio_splitted_decoder_v0/model.pt``; models-dir contract
``ref:map_detector_core.py:64-76``) but never loads it — here it serves
reconstruction-side parity validation of an ingested encoder (``--verify``
on a runnable pickled module, the ingested decoder on ``--device``, the
card by default) and warm starts (``train-vae --init-from-decoder``).

Vocabulary (shape-parsed, names ignored): leading Linear layers, then a conv
stack of 4x4 ConvTranspose2d (x2 upsample) and/or 3x3 Conv2d with optional
GroupNorm (kept) / BatchNorm (folded) / no norm; in an all-3x3 stack every
conv except the output conv is preceded by a nearest x2 upsample.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from anuraxla_torch import resolve_device
from anuraxla_torch.cli.common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pt", required=True, help="torch decoder checkpoint (.pt)")
    p.add_argument("--yaml", default=None, help="Hydra YAML sidecar (optional)")
    p.add_argument("--out", required=True, help="output artifact directory")
    p.add_argument("--n-mels", type=int, default=64)
    p.add_argument("--groups", type=int, default=None,
                   help="GroupNorm groups (default: from YAML, else 8)")
    p.add_argument("--verify", action="store_true",
                   help="require reconstruction parity vs the pickled torch "
                   "module before saving (runnable-module checkpoints only)")
    p.add_argument("--tol", type=float, default=1e-4)
    add_device_arg(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from anuraxla_torch.models.checkpoint import save_decoder
    from anuraxla_torch.models.hydra_ingest import ingest_foreign_decoder

    dev = resolve_device(args.device) if args.verify else None
    spec, state, meta = ingest_foreign_decoder(
        args.pt, args.yaml, n_mels=args.n_mels, groups=args.groups,
    )
    print(f"🔍 inferred: dense={list(spec.dense_widths)} "
          f"bottleneck={spec.bottleneck_hw}x{spec.bottleneck_c} "
          f"stack={list(spec.stack)} norm={spec.norm}")
    print(f"🔍 reconstructs: {spec.out_hw} (latent_dim={spec.latent_dim})")

    if args.verify:
        err = verify_against_torch(args.pt, spec, state, dev)
        if err > args.tol:
            raise SystemExit(
                f"❌ reconstruction mismatch vs torch module: max|Δ|={err:.3e} > {args.tol}"
            )
        print(f"✅ verified vs torch module: max|Δ|={err:.3e}")

    out = save_decoder(Path(args.out), spec, state)
    print(f"💾 artifact: {out} (use with train-vae --init-from-decoder {out})")


def verify_against_torch(pt_path, spec, state, device) -> float:
    """Max abs reconstruction difference between the ingested decoder on
    ``device`` and the pickled torch module (on the CPU) on random latents."""
    from anuraxla_torch.models.vae import IngestedDecoder

    ckpt = torch.load(str(pt_path), map_location="cpu", weights_only=False)
    if not isinstance(ckpt, torch.nn.Module):
        raise SystemExit(
            "❌ --verify needs a runnable pickled module checkpoint (a bare "
            "state_dict has no forward to compare against) — drop --verify"
        )
    z = np.random.default_rng(0).standard_normal((2, spec.latent_dim)).astype(np.float32)
    with torch.no_grad():
        ref = ckpt.eval()(torch.from_numpy(z)).numpy()  # [B, C, T, M]
    dec = IngestedDecoder(spec)
    dec.load_state_dict(state)
    dec = dec.eval().to(device)
    with torch.inference_mode():
        got = dec(torch.from_numpy(z).to(device)).cpu().numpy()  # [B, T, M, C]
    return float(np.abs(np.moveaxis(got, -1, 1) - ref).max())


if __name__ == "__main__":
    main()
