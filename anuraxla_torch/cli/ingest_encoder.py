"""``ingest-encoder`` on the port — ``anuraxla/cli/ingest_encoder.py``:
convert a reference-style torch encoder artifact (checkpoint .pt + optional
Hydra YAML) into an encoder artifact (``encoder.msgpack`` + ``encoder.json``,
the JAX package's format, written by ``models.checkpoint.save_encoder``),
discovering the architecture and target_frames from the weights.

This is the migration path for the reference's external model
(``ref:map_detector_core.py:150-179`` loads it via hydra-instantiate of a
private package; ``ref:07:355-409`` discovers target_frames with a forward
hook): shape-based ingest (``models.hydra_ingest``), closed-form
auto-frames, and an artifact that records its input shape so every other
tool just works. ``--verify`` rebuilds the torch module from the YAML's
``_target_`` tree (torch.nn vocabulary), runs it on the CPU and the
ingested encoder on ``--device`` (the card by default), and requires latent
parity before saving.
"""

from __future__ import annotations

import argparse
import warnings
from pathlib import Path

import numpy as np
import torch

from anuraxla_torch import resolve_device
from anuraxla_torch.cli.common import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pt", required=True, help="torch checkpoint (.pt)")
    p.add_argument("--yaml", default=None, help="Hydra YAML sidecar (optional)")
    p.add_argument("--out", required=True, help="output artifact directory")
    p.add_argument("--n-mels", type=int, default=64)
    p.add_argument("--groups", type=int, default=None,
                   help="GroupNorm groups (default: from YAML, else 8)")
    p.add_argument("--verify", action="store_true",
                   help="rebuild the torch module from the YAML _target_ tree "
                   "and require latent parity before saving")
    p.add_argument("--tol", type=float, default=1e-4)
    p.add_argument("--downsample", choices=["auto", "stride", "avgpool"],
                   default="auto",
                   help="force the downsampling reading for ambiguous bare "
                   "state_dicts (repeated-width avgpool chains can also parse "
                   "as stride pairs; pickled runnable modules disambiguate "
                   "themselves via the forward-hook probe)")
    add_device_arg(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from anuraxla_torch.models.checkpoint import save_encoder
    from anuraxla_torch.models.hydra_ingest import ingest_foreign_checkpoint

    dev = resolve_device(args.device) if args.verify else None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg, state, meta = ingest_foreign_checkpoint(
            args.pt, args.yaml, n_mels=args.n_mels, groups=args.groups,
            downsample=None if args.downsample == "auto" else args.downsample,
        )
    for w in caught:
        print(f"⚠️ {w.message}")
    print(f"🔍 inferred: widths={list(cfg.widths)} dense={cfg.dense_width} "
          f"latent={cfg.latent_dim} groups={cfg.groups}")
    print(f"🔍 auto-frames: target_frames={cfg.input_hw[0]} (n_mels={cfg.input_hw[1]})")

    if args.verify:
        if not args.yaml:
            raise SystemExit("❌ --verify needs --yaml (to rebuild the torch module)")
        err = verify_against_torch(args.pt, args.yaml, cfg, state, dev)
        if err > args.tol:
            raise SystemExit(f"❌ latent mismatch vs torch module: max|Δ|={err:.3e} > {args.tol}")
        print(f"✅ verified vs torch module: max|Δ|={err:.3e}")

    out = save_encoder(Path(args.out), cfg, state)
    print(f"💾 artifact: {out} (use with --encoder {out})")


def verify_against_torch(pt_path, yaml_path, cfg, state, device) -> float:
    """Max abs latent difference between the ingested encoder on ``device``
    and the torch module rebuilt from the YAML _target_ tree (on the CPU), on
    random mel input."""
    from anuraxla_torch.models.hydra_ingest import (
        build_nn_module,
        instantiate_target_tree,
        load_yaml_cfg,
        pick_encoder_cfg,
        split_model_and_state,
    )
    from anuraxla_torch.models.vae import ConvVAEEncoder

    module = build_nn_module(instantiate_target_tree(pick_encoder_cfg(load_yaml_cfg(yaml_path))))
    ckpt = torch.load(str(pt_path), map_location="cpu", weights_only=False)
    sd = split_model_and_state(ckpt)
    # the reference loads strict=False (ref:map_detector_core.py:176) — but a
    # verification oracle left at random init is worse than no oracle, so
    # require every checkpoint tensor to land somewhere
    result = module.load_state_dict(sd, strict=False)
    n_loaded = len(sd) - len(result.unexpected_keys)
    if n_loaded == 0 or result.missing_keys:
        raise SystemExit(
            "❌ --verify could not rebuild the torch oracle: the YAML-built "
            f"module loaded {n_loaded}/{len(sd)} checkpoint tensors "
            f"(missing={result.missing_keys[:3]}, "
            f"unexpected={result.unexpected_keys[:3]}). The shape-based "
            "ingest itself does not need matching names — drop --verify, or "
            "provide a YAML whose module names match the checkpoint's."
        )
    module.eval()

    t, m = cfg.input_hw
    x = np.random.default_rng(0).standard_normal((2, 1, t, m)).astype(np.float32)
    with torch.no_grad():
        out = module(torch.from_numpy(x))
    z_torch = _extract_latent(out)

    enc = ConvVAEEncoder(cfg)
    enc.load_state_dict(state)
    enc = enc.eval().to(device)
    with torch.inference_mode():
        z = enc(torch.from_numpy(x.transpose(0, 2, 3, 1).copy()).to(device))["mu"].cpu().numpy()
    return float(np.abs(z_torch - z).max())


def _extract_latent(out) -> np.ndarray:
    """Reference output-key probing order z/latent/mu/mean/embedding
    (``ref:map_detector_core.py:279-288``); tensors/tuples taken as-is."""
    if isinstance(out, dict):
        for k in ("z", "latent", "mu", "mean", "embedding"):
            if k in out and isinstance(out[k], torch.Tensor):
                return out[k].numpy()
        raise ValueError(f"no latent key in module output: {list(out)}")
    if isinstance(out, (tuple, list)):
        out = out[0]
    return out.numpy()


if __name__ == "__main__":
    main()
