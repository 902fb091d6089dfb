"""``calibrate-tau`` on the port — sweep the MAP detector's rejection
threshold τ over quantiles of the true-class training scores and evaluate
accuracy / NO_DETECT on a validation tree (as ``anuraxla/cli/calibrate_tau.py``).

Latents are encoded once; the fit and the whole τ grid
(``detect.calibrate.map_tau_sweep``) run on the session's device, the card
unless ``--device cpu``. Writes tau_grid.csv and, with ``--set-best``, the
best-accuracy τ into config.json's map_detector (backup ``config.json.bak``).

    python -m anuraxla_torch calibrate-tau --train-root train_chunks --val-root val_chunks --set-best
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np
import torch

from anuraxla_torch.cli.common import (
    add_batch_args, add_device_arg, add_encoder_args, add_mel_args, mel_from_args, project_root_here, resolve_config,
    resolve_root_dir, session_kwargs,
)
from anuraxla_torch.config import get_chunk_seconds, require_species
from anuraxla_torch.constants import CACHE_DIR_NAME
from anuraxla_torch.detect.calibrate import map_tau_sweep
from anuraxla_torch.detect.gaussian_map import fit_map
from anuraxla_torch.pipeline.session import (
    EncoderSession, concat_species_latents, encode_species_tree, pad_species_latents,
)
from anuraxla_torch.utils.io import load_json, save_json_with_backup


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, default="config.json")
    p.add_argument("--train-root", type=str, default="train_chunks")
    p.add_argument("--val-root", type=str, default="val_chunks")
    p.add_argument("--tau-q-grid", type=float, nargs="*",
                   default=[0.001, 0.005, 0.01, 0.02, 0.05, 0.10, 0.20])
    p.add_argument("--cov-type", type=str, default="lda", choices=["lda", "qda"])
    p.add_argument("--cov-structure", type=str, default="full", choices=["full", "diag"])
    p.add_argument("--priors", type=str, default="empirical", choices=["empirical", "uniform"])
    p.add_argument("--eps", type=float, default=1e-6)
    p.add_argument("--shrink", type=float, default=0.0)
    p.add_argument("--max-per-class", type=int, default=0)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--cache", action="store_true")
    p.add_argument("--out", type=str, default=None, help="tau_grid.csv path")
    p.add_argument("--set-best", action="store_true",
                   help="write the best-accuracy tau into config.json's map_detector")
    add_device_arg(p)
    add_mel_args(p)
    add_encoder_args(p)
    add_batch_args(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    project_root = project_root_here()
    cfg_path = resolve_config(args.config, project_root)
    cfg = load_json(cfg_path)
    species_all = require_species(cfg)
    train_dir = resolve_root_dir(args.train_root, project_root)
    val_dir = resolve_root_dir(args.val_root, project_root)

    session = EncoderSession(
        mel=mel_from_args(args, get_chunk_seconds(cfg)),
        encoder_dir=Path(args.encoder) if args.encoder else None,
        project_root=project_root,
        device=args.device,
        **session_kwargs(args),
    ).load()
    dev = session.dev

    Z_by, _, _ = encode_species_tree(
        session, train_dir, species_all,
        cache=args.cache, cache_dir=project_root / CACHE_DIR_NAME,
        max_per_class=args.max_per_class, seed=args.seed,
    )
    Z_by = {sp: Z_by[sp] for sp in sorted(Z_by)}
    species, Z, mask = pad_species_latents(Z_by)
    fit = fit_map(
        torch.from_numpy(Z).to(dev), torch.from_numpy(mask).to(dev),
        cov_type=args.cov_type, cov_structure=args.cov_structure,
        priors_mode=args.priors, eps=args.eps, shrink=args.shrink,
    )

    Zv_by, _, _ = encode_species_tree(
        session, val_dir, species, cache=False, cache_dir=None,
        max_per_class=0, seed=args.seed,
    )
    Zv, true_idx = concat_species_latents(Zv_by, species)

    taus, acc, nodet = map_tau_sweep(
        fit.scores_true_sorted, fit.n_scores,
        torch.from_numpy(Zv).to(dev), torch.from_numpy(true_idx).to(dev),
        fit.means, fit.precisions, fit.logdets, fit.priors,
        np.asarray(args.tau_q_grid, np.float32),
    )
    taus, acc, nodet = (x.cpu().numpy() for x in (taus, acc, nodet))

    print("\n tau_q       tau          val_acc  val_no_detect")
    for q, t, a, n in zip(args.tau_q_grid, taus, acc, nodet):
        print(f"  {q:6.3f}  {t:12.4f}  {a * 100:7.2f}%  {n * 100:7.2f}%")

    out = Path(args.out) if args.out else (project_root / "outputs" / "tau_grid.csv")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["tau_q", "tau", "val_accuracy", "val_no_detect_rate"])
        for q, t, a, n in zip(args.tau_q_grid, taus, acc, nodet):
            w.writerow([q, float(t), float(a), float(n)])
    print(f"💾 {out}")

    if args.set_best:
        best = int(np.argmax(acc))
        md = cfg.get("map_detector")
        if not isinstance(md, dict):
            raise SystemExit("❌ config has no map_detector block — run fit-map first.")
        md["tau"] = float(taus[best])
        md.setdefault("meta_fit", {})["tau_from_train_quantile"] = float(args.tau_q_grid[best])
        backup = save_json_with_backup(cfg_path, cfg)
        print(f"✅ tau={float(taus[best]):.4f} (q={args.tau_q_grid[best]}) written to {cfg_path} (backup {backup})")


if __name__ == "__main__":
    main()
