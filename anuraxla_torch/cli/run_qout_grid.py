"""``run-qout-grid`` on the port — the q_out calibration grid with per-run
snapshots (the reference's ``run_qout_grid.sh`` + ``9200_run_qout_grid_with_
snapshot.py``, as ``anuraxla/cli/run_qout_grid.py``).

For each q_out it refits the radial detector on the train tree, benchmarks
the val tree, and writes the reference's artifact set into
<grid_root>/qout_<q>/: run.log, summary.txt, results.csv, the four PNGs,
config_used.json and config_snapshot.json (scraped from run.log by
``snapshot_from_log.write_snapshot``). ``--analyze`` then runs the Spearman
analysis.

- default: one in-process session; the train tree is encoded once (latent
  cache) and every point refits and benchmarks with it;
- ``--device-sweep``: also the whole (q_in × q_out) grid as one sweep on the
  device (``detect.calibrate.radial_qgrid``) from one fit's sorted pools,
  written to grid_metrics.csv; ``--noise-margin-db`` adds the grid on noised
  val latents and recommends an operating point;
- ``--subprocess-compat``: spawn ``python -m anuraxla_torch fit-radial`` and
  ``benchmark-folder`` for each point, the reference's operational flow.

Everything runs on the card unless ``--device cpu``.

    python -m anuraxla_torch run-qout-grid --serving-tier balanced --device-sweep --q-in-grid 0.9 0.95 0.99 --analyze
"""

from __future__ import annotations

import argparse
import csv
import io
import os
import shutil
import subprocess
import sys
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from anuraxla_torch.cli.common import (
    add_batch_args, add_device_arg, add_encoder_args, add_mel_args, mel_from_args, project_root_here, resolve_config,
    resolve_root_dir, resolve_tier_knobs, session_kwargs,
)
from anuraxla_torch.cli.fit_radial import parse_augment
from anuraxla_torch.cli.snapshot_from_log import write_snapshot
from anuraxla_torch.cli.spearman_analysis import analyze_grid
from anuraxla_torch.config import get_chunk_seconds, priority_ranks, require_species
from anuraxla_torch.constants import CACHE_DIR_NAME
from anuraxla_torch.detect.calibrate import radial_qgrid
from anuraxla_torch.pipeline.benchmark import run_folder_benchmark
from anuraxla_torch.pipeline.fit import _fit_mesh, _fit_radial_dispatch, encode_augmented_tree, fit_radial_tree
from anuraxla_torch.pipeline.session import (
    EncoderSession, concat_species_latents, encode_species_tree, pad_species_latents,
)
from anuraxla_torch.utils.io import load_json
from anuraxla_torch.utils.timing import stage_timer


def subprocess_shared_args(args, cfg_path) -> list:
    """The flags forwarded to every spawned fit / benchmark process in
    --subprocess-compat mode: every parameter that changes results, the tier
    knobs resolved (``resolve_tier_knobs``), so children reproduce the
    parent's operating point however it was spelled."""
    knobs = resolve_tier_knobs(args)
    shared = [
        "--config", str(cfg_path), "--device", args.device,
        "--sr", str(args.sr), "--n-mels", str(args.n_mels),
        "--target-frames", str(args.target_frames),
        "--fmin", str(args.fmin), "--fmax", str(args.fmax),
        "--hop-length", str(args.hop_length), "--n-fft", str(args.n_fft),
        "--batch-size", str(args.batch_size), "--io-threads", str(args.io_threads),
        "--frontend-backend", knobs["frontend_backend"],
        "--encoder-dtype", knobs["encoder_dtype"],
        "--serving-tier", args.serving_tier,
    ]
    for flag, on in (
        ("--fast-frontend", knobs["fast_frontend"]),
        ("--transfer-int16", args.transfer_int16),
        ("--quantize-serving", args.quantize_serving),
        ("--pre-padded-host", args.pre_padded_host),
        ("--data-parallel", args.data_parallel),
    ):
        if on:
            shared.append(flag)
    if args.encoder:
        shared += ["--encoder", args.encoder]
    return shared


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, default="config.json")
    p.add_argument("--train-root", type=str, default="train_chunks")
    p.add_argument("--val-root", type=str, default="val_chunks")
    p.add_argument("--q-in", type=float, default=0.95)
    p.add_argument("--q-out-grid", type=float, nargs="*", default=[0.10, 0.15, 0.20, 0.25])
    p.add_argument("--max-per-class", type=int, default=400)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--grid-root", type=str, default=None,
                   help="default: <project>/outputs/qout_grid_<YYYYMMDD>")
    p.add_argument("--subprocess-compat", action="store_true")
    p.add_argument("--analyze", action="store_true", help="run spearman analysis at the end")
    p.add_argument("--device-sweep", action="store_true",
                   help="additionally evaluate the FULL (q_in x q_out) grid as "
                   "one on-device sweep (detect.calibrate.radial_qgrid) and "
                   "write grid_metrics.csv — no re-encoding, no per-point refits")
    p.add_argument("--q-in-grid", type=float, nargs="*", default=None,
                   help="q_in values for --device-sweep (default: just --q-in)")
    p.add_argument("--noise-margin-db", type=float, default=None,
                   help="with --device-sweep: also evaluate the grid on "
                   "noise-injected val latents at this SNR (dB) and recommend "
                   "the operating point with the best NOISED accuracy whose "
                   "CLEAN accuracy is within 2 points of the clean optimum")
    p.add_argument("--augment-noise-db", type=str, default=None,
                   help="comma list of SNRs (dB): every fit in this grid "
                   "(per-point refits AND the --device-sweep fit) runs on the "
                   "noise-augmented latent pool")
    p.add_argument("--noise-seed", type=int, default=0,
                   help="seed for --augment-noise-db / --noise-margin-db injection")
    add_device_arg(p)
    add_mel_args(p)
    add_encoder_args(p)
    add_batch_args(p)
    return p


class Tee(io.TextIOBase):
    def __init__(self, *sinks):
        self.sinks = sinks

    def write(self, s):
        for k in self.sinks:
            k.write(s)
        return len(s)

    def flush(self):
        for k in self.sinks:
            k.flush()


def _run_point_subprocess(args, cfg_path, train_dir, val_dir, bench_out, q_out, runlog) -> None:
    shared = subprocess_shared_args(args, cfg_path)
    fit_extra = (
        ["--augment-noise-db", args.augment_noise_db, "--noise-seed", str(args.noise_seed)]
        if args.augment_noise_db else []
    )
    env = dict(os.environ)
    repo_root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = repo_root + (":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    with open(runlog, "w", encoding="utf-8") as lf:
        for cmd in (
            [sys.executable, "-m", "anuraxla_torch", "fit-radial",
             "--root", str(train_dir), "--q-in", str(args.q_in), "--q-out", str(q_out),
             "--max-per-class", str(args.max_per_class), "--cache",
             "--seed", str(args.seed)] + fit_extra + shared,
            [sys.executable, "-m", "anuraxla_torch", "benchmark-folder",
             "--root", str(val_dir), "--out-dir", str(bench_out)] + shared,
        ):
            r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            lf.write(r.stdout)
            sys.stdout.write(r.stdout)
            if r.returncode != 0:
                raise SystemExit(f"❌ grid step failed: {' '.join(cmd)}")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    project_root = project_root_here()
    cfg_path = resolve_config(args.config, project_root)
    train_dir = resolve_root_dir(args.train_root, project_root)
    val_dir = resolve_root_dir(args.val_root, project_root)

    grid_root = (
        Path(args.grid_root).expanduser().resolve()
        if args.grid_root
        else project_root / "outputs" / f"qout_grid_{datetime.now().strftime('%Y%m%d')}"
    )
    grid_root.mkdir(parents=True, exist_ok=True)
    bench_out = project_root / "outputs" / "detection_benchmark"

    print(f"📌 project root: {project_root}")
    print(f"📁 grid root:   {grid_root}")
    print(f"🎯 q_in={args.q_in} | grid={args.q_out_grid} | max_per_class={args.max_per_class}")

    augment_db = parse_augment(args.augment_noise_db)
    session = None
    if not args.subprocess_compat:
        session = EncoderSession(
            mel=mel_from_args(args, get_chunk_seconds(load_json(cfg_path))),
            encoder_dir=Path(args.encoder) if args.encoder else None,
            project_root=project_root,
            noise_seed=args.noise_seed,
            device=args.device,
            **session_kwargs(args),
        ).load()

    for q_out in args.q_out_grid:
        outdir = grid_root / f"qout_{q_out:.2f}"
        outdir.mkdir(parents=True, exist_ok=True)
        runlog = outdir / "run.log"
        print("=" * 40)
        print(f"▶ q_out={q_out} (q_in={args.q_in}) -> {outdir}")

        with stage_timer(f"grid point q_out={q_out}"):
            if args.subprocess_compat:
                _run_point_subprocess(args, cfg_path, train_dir, val_dir, bench_out, q_out, runlog)
            else:
                with open(runlog, "w", encoding="utf-8") as lf:
                    tee = Tee(sys.stdout, lf)
                    log = lambda *a: print(*a, file=tee)  # noqa: E731
                    fit_radial_tree(
                        cfg_path=cfg_path, cfg=load_json(cfg_path), chunks_dir=train_dir, session=session,
                        q_in=args.q_in, q_out=q_out, cache=True,
                        cache_dir=project_root / CACHE_DIR_NAME,
                        max_per_class=args.max_per_class, seed=args.seed,
                        augment_noise_db=augment_db, log=log,
                    )
                    run_folder_benchmark(
                        root=val_dir, config_path=cfg_path, detector="radial",
                        session=session, out_dir=bench_out, log=log,
                    )

        # collect artifacts like run_qout_grid.sh:42-50
        for name in ("summary.txt", "results.csv", "confusion_matrix.png",
                     "accuracy_by_class.png", "no_detect_rate_by_class.png",
                     "global_counts.png"):
            src = bench_out / name
            if src.exists():
                shutil.copyfile(src, outdir / name)
        shutil.copyfile(cfg_path, outdir / "config_used.json")

        snap = write_snapshot(runlog, outdir / "config_snapshot.json", args.q_in, q_out)
        if not snap["rk_per_species"]:
            print("⚠️ snapshot has no rk values — fit log format changed?")
        print(f"✅ saved -> {outdir}")

    if args.device_sweep:
        if args.subprocess_compat:
            print("⚠️ --device-sweep needs the in-process session; skipping")
        else:
            _device_sweep(args, session, cfg_path, train_dir, val_dir, grid_root, project_root)

    if args.analyze:
        analyze_grid(grid_root)


def _device_sweep(args, session, cfg_path, train_dir, val_dir, grid_root, project_root):
    """Encode train (cached) and val once, fit once on the device, then
    evaluate every (q_in, q_out) pair from the fit's sorted pools in one
    batched sweep there."""
    species_all = require_species(load_json(cfg_path))
    Z_by, _, _ = encode_augmented_tree(
        session, train_dir, species_all, augment_noise_db=parse_augment(args.augment_noise_db),
        cache=True, cache_dir=project_root / CACHE_DIR_NAME,
        max_per_class=args.max_per_class, seed=args.seed, log=lambda *a: None,
    )
    species, Z, mask = pad_species_latents(Z_by)
    # sample-sharded fit when the session is data-parallel (parallel.fit)
    fit = _fit_radial_dispatch(session, Z, mask, args.q_in, args.q_out_grid[0])
    dev = fit.centroids.device

    def val_latents():
        Zv_by, _, _ = encode_species_tree(
            session, val_dir, species, cache=False, cache_dir=None,
            max_per_class=0, seed=args.seed, log=lambda *a: None,
        )
        Zv, true_idx = concat_species_latents(Zv_by, species)
        return torch.from_numpy(Zv).to(dev), torch.from_numpy(true_idx).to(dev)

    Zv, true_idx = val_latents()
    # data-parallel: the val latents padded to the data axis, as the
    # reference shards them, with the pad rows masked out of the metrics
    valid = None
    mesh = _fit_mesh(session)
    if mesh is not None:
        n_data, B = mesh.shape["data"], Zv.shape[0]
        rem = (-B) % n_data
        Zv, true_idx = torch.cat([Zv, Zv.new_zeros((rem, Zv.shape[1]))]), torch.cat([true_idx, true_idx.new_zeros(rem)])
        valid = torch.arange(Zv.shape[0], device=dev) < B
        print(f"🕸️ device sweep sharded over {n_data} shards (B={B})")
    q_in_grid = args.q_in_grid if args.q_in_grid else [args.q_in]
    ranks = torch.from_numpy(priority_ranks(species)).to(dev)
    qi, qo = np.asarray(q_in_grid, np.float32), np.asarray(args.q_out_grid, np.float32)
    with stage_timer(f"device sweep {len(q_in_grid)}x{len(args.q_out_grid)} grid"):
        gm = radial_qgrid(fit, Zv, true_idx, ranks, qi, qo, valid)
        acc, nod, accp, nodp = (x.cpu().numpy() for x in (
            gm.accuracy, gm.no_detect_rate, gm.acc_per_class, gm.no_detect_per_class))

    acc_nz = nod_nz = None
    if args.noise_margin_db is not None:
        # same fit, noised evaluation latents: pick (q_in, q_out) by noised
        # accuracy subject to clean accuracy within 2 points
        session.add_noise_db = float(args.noise_margin_db)
        try:
            Zn, true_n = val_latents()
        finally:
            session.add_noise_db = None
        gmn = radial_qgrid(fit, Zn, true_n, ranks, qi, qo)
        acc_nz, nod_nz = gmn.accuracy.cpu().numpy(), gmn.no_detect_rate.cpu().numpy()

    out = grid_root / "grid_metrics.csv"
    with open(out, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        header = ["q_in", "q_out", "val_accuracy", "val_no_detect_rate"]
        if acc_nz is not None:
            header += [f"val_accuracy_snr{args.noise_margin_db:g}db",
                       f"val_no_detect_rate_snr{args.noise_margin_db:g}db"]
        header += [f"acc_{sp}" for sp in species] + [f"no_detect_{sp}" for sp in species]
        w.writerow(header)
        for i, q_in in enumerate(q_in_grid):
            for j, q_out in enumerate(args.q_out_grid):
                row = [q_in, q_out, float(acc[i, j]), float(nod[i, j])]
                if acc_nz is not None:
                    row += [float(acc_nz[i, j]), float(nod_nz[i, j])]
                row += [float(v) for v in accp[i, j]] + [float(v) for v in nodp[i, j]]
                w.writerow(row)
    print(f"💾 on-device grid metrics: {out}")

    if acc_nz is not None:
        q_in, q_out = recommend_operating_point(acc, acc_nz, q_in_grid, args.q_out_grid)
        print(
            f"🎯 noise-margin operating point (SNR {args.noise_margin_db:g} dB): "
            f"q_in={q_in:g} q_out={q_out:g} — best noised accuracy within 2 points "
            "of the clean optimum; refit with these to adopt it"
        )


def recommend_operating_point(acc_clean, acc_noise, q_in_grid, q_out_grid, margin: float = 0.02):
    """(q_in, q_out) maximizing NOISED accuracy among points whose CLEAN
    accuracy is within ``margin`` of the clean optimum (ties -> higher clean
    accuracy)."""
    acc_clean = np.asarray(acc_clean)
    acc_noise = np.asarray(acc_noise)
    eligible = acc_clean >= acc_clean.max() - margin
    score = np.where(eligible, acc_noise + 1e-6 * acc_clean, -1.0)
    i, j = np.unravel_index(int(score.argmax()), score.shape)
    return float(q_in_grid[i]), float(q_out_grid[j])


if __name__ == "__main__":
    main()
