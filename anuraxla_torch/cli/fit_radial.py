"""``fit-radial`` on the port — fit the per-species radial detector (the
reference's ``08_fit_radial_detector.py`` contract, as
``anuraxla/cli/fit_radial.py``: same flags, the same config.json block, the
same ✅ rk stdout lines that the snapshot tool regex-parses). Encoding and
the fit run on the card unless ``--device cpu``.

    python -m anuraxla_torch.cli.fit_radial --root train_chunks --serving-tier balanced
"""

from __future__ import annotations

import argparse
from pathlib import Path

from anuraxla_torch.cli.common import (
    add_batch_args, add_device_arg, add_encoder_args, add_mel_args, mel_from_args, project_root_here, resolve_config,
    resolve_root_dir, session_kwargs,
)
from anuraxla_torch.config import get_chunk_seconds
from anuraxla_torch.constants import CACHE_DIR_NAME
from anuraxla_torch.pipeline.fit import fit_radial_tree
from anuraxla_torch.pipeline.session import EncoderSession
from anuraxla_torch.utils.io import load_json


def add_fit_args(p: argparse.ArgumentParser) -> None:
    """The flags fit-radial and fit-map share."""
    p.add_argument("--config", type=str, default="config.json")
    p.add_argument("--root", type=str, required=True, help="folder with per-species subfolders (train_chunks/...)")
    add_device_arg(p)
    add_mel_args(p)
    add_encoder_args(p)
    add_batch_args(p)
    p.add_argument("--max-per-class", type=int, default=0)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--cache", action="store_true")
    p.add_argument("--cache-dir", type=str, default=None)
    p.add_argument("--augment-noise-db", type=str, default=None,
                   help="comma list of SNRs (dB): also fit on noise-injected copies of the training latents")
    p.add_argument("--noise-seed", type=int, default=0, help="seed for --augment-noise-db injection")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--q-in", type=float, default=0.95)
    p.add_argument("--q-out", type=float, default=0.01)
    add_fit_args(p)
    return p


def parse_augment(arg) -> list:
    return [float(s) for s in arg.split(",") if s.strip()] if arg else []


def fit_setup(args):
    """-> (project_root, cfg_path, cfg, chunks_dir, session, cache_dir),
    with the reference's header lines printed."""
    project_root = project_root_here()
    cfg_path = resolve_config(args.config, project_root)
    cfg = load_json(cfg_path)
    chunks_dir = resolve_root_dir(args.root, project_root)
    print(f"📌 project root: {project_root}")
    print(f"🧾 config: {cfg_path}")
    print(f"📁 chunks dir: {chunks_dir}")
    session = EncoderSession(
        mel=mel_from_args(args, get_chunk_seconds(cfg)),
        encoder_dir=Path(args.encoder) if args.encoder else None,
        project_root=project_root,
        noise_seed=args.noise_seed,
        device=args.device,
        **session_kwargs(args),
    )
    cache_dir = Path(args.cache_dir) if args.cache_dir else (project_root / CACHE_DIR_NAME)
    return cfg_path, cfg, chunks_dir, session, cache_dir


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if not (0.0 < args.q_in < 1.0):
        raise SystemExit("❌ --q-in must be in (0,1).")
    if not (0.0 < args.q_out < 1.0):
        raise SystemExit("❌ --q-out must be in (0,1).")
    cfg_path, cfg, chunks_dir, session, cache_dir = fit_setup(args)
    print(f"🎯 q_in={args.q_in} | q_out={args.q_out} | max_per_class={args.max_per_class} | cache={args.cache}")
    fit_radial_tree(
        cfg_path=cfg_path, cfg=cfg, chunks_dir=chunks_dir, session=session.load(),
        q_in=args.q_in, q_out=args.q_out,
        cache=args.cache, cache_dir=cache_dir,
        max_per_class=args.max_per_class, seed=args.seed,
        augment_noise_db=parse_augment(args.augment_noise_db),
    )


if __name__ == "__main__":
    main()
