"""``benchmark-folder`` on the port — labelled-folder detection benchmark with
the radial detector (the reference's ``10_benchmark_folder_detection.py``, as
``anuraxla/cli/benchmark_folder.py``: folder name = ground truth; writes
results.csv, summary.txt and the four PNGs under outputs/detection_benchmark/).
Encoding and decisions run on the card unless ``--device cpu``.

    python -m anuraxla_torch benchmark-folder --root val_chunks --serving-tier balanced
    python -m anuraxla_torch benchmark-folder --root val_chunks --snr-sweep clean,20,14,8
"""

from __future__ import annotations

import argparse
from pathlib import Path

from anuraxla_torch.cli.common import (
    add_batch_args, add_device_arg, add_encoder_args, add_mel_args, mel_from_args, project_root_here, resolve_config,
    session_kwargs,
)
from anuraxla_torch.pipeline.benchmark import run_folder_benchmark, run_snr_sweep
from anuraxla_torch.pipeline.session import EncoderSession

DEFAULT_OUT = "outputs/detection_benchmark"
DETECTOR = "radial"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", type=str, default=None,
                   help="folder to scan (default: <root>/latent_space_exploration/test_chunks)")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--out-dir", type=str, default=None)
    p.add_argument("--add-noise-db", type=float, default=None,
                   help="inject broadband noise at this SNR (dB vs each "
                   "chunk's RMS) before the pipeline — robustness evaluation")
    p.add_argument("--snr-sweep", type=str, default=None,
                   help="comma list of SNRs (dB; 'clean' allowed), e.g. "
                   "'clean,20,14,8': run the benchmark at each and write "
                   "snr_curve.csv + per-SNR artifact dirs")
    p.add_argument("--noise-seed", type=int, default=0)
    add_device_arg(p)
    add_mel_args(p)
    add_encoder_args(p)
    add_batch_args(p)
    return p


def run(detector: str, default_out: str, default_root_name: str = "test_chunks", argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.add_noise_db is not None and args.snr_sweep:
        raise SystemExit(
            "❌ --add-noise-db and --snr-sweep are mutually exclusive: the "
            "sweep sets the noise level per point (add the dB value to the "
            "sweep list instead)"
        )
    project_root = project_root_here()
    cfg_path = resolve_config(args.config or "config.json", project_root)

    root = (
        Path(args.root).expanduser().resolve()
        if args.root
        else (project_root / "latent_space_exploration" / default_root_name)
    )
    if not root.exists():
        raise SystemExit(f"❌ root not found: {root}")
    out_dir = Path(args.out_dir) if args.out_dir else (project_root / default_out)

    print("=" * 70)
    print(f"🔎 FOLDER DETECTION BENCHMARK{' — MAP' if detector == 'map' else ''}")
    print(f"root:    {root}")
    print(f"config:  {cfg_path}")
    print(f"outputs: {out_dir}")
    print("=" * 70)

    session = EncoderSession(
        mel=mel_from_args(args, duration=5.0),
        encoder_dir=Path(args.encoder) if args.encoder else None,
        project_root=project_root,
        add_noise_db=args.add_noise_db,
        noise_seed=args.noise_seed,
        device=args.device,
        **session_kwargs(args),
    ).load()
    if args.snr_sweep:
        snrs = [
            None if s.strip().lower() == "clean" else float(s)
            for s in args.snr_sweep.split(",") if s.strip()
        ]
        run_snr_sweep(
            root=root, config_path=cfg_path, detector=detector,
            session=session, out_dir=out_dir, snrs_db=snrs,
        )
    else:
        run_folder_benchmark(
            root=root, config_path=cfg_path, detector=detector,
            session=session, out_dir=out_dir,
        )


def main(argv=None) -> None:
    run(DETECTOR, DEFAULT_OUT, argv=argv)


if __name__ == "__main__":
    main()
