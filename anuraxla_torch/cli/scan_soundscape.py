"""``scan-soundscape`` on the port — windowed detection over long recordings
(as ``anuraxla/cli/scan_soundscape.py``; the reference truncates any input to
chunk_seconds). ``--wav`` scans one recording, ``--root`` every .wav under a
directory through one session (fleet mode: windows of all recordings share
the device batches). Writes per-window detection CSVs and prints a
per-species window count; ``--extract-dir`` also writes each detected window
as a labelled chunk WAV.

Per-window RMS normalization runs fused into the mel kernel on the device
(``normalize_on_device``) unless ``--no-normalize``. Everything runs on the
card unless ``--device cpu``.

    python -m anuraxla_torch scan-soundscape --root field_season/ --hop-seconds 2.5 --serving-tier balanced
"""

from __future__ import annotations

import argparse
from collections import Counter
from pathlib import Path

from anuraxla_torch.cli.common import (
    add_batch_args, add_device_arg, add_encoder_args, add_mel_args, mel_from_args, project_root_here, resolve_config,
    session_kwargs,
)
from anuraxla_torch.pipeline.session import EncoderSession
from anuraxla_torch.pipeline.stream import extract_detected_chunks, scan_soundscapes, write_detections_csv
from anuraxla_torch.utils.io import load_json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav", type=str, default=None, help="long recording to scan")
    p.add_argument("--root", type=str, default=None,
                   help="fleet mode: scan EVERY .wav under this directory "
                   "(recursive) through one session; per-file detection CSVs "
                   "land next to each recording (or under --out as a directory)")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--detector", type=str, default="radial", choices=["radial", "map"])
    p.add_argument("--hop-seconds", type=float, default=None,
                   help="window hop (default: chunk_seconds, i.e. no overlap)")
    p.add_argument("--no-normalize", action="store_true",
                   help="skip per-window RMS normalization")
    p.add_argument("--out", type=str, default=None, help="detections CSV path")
    p.add_argument("--extract-dir", type=str, default=None,
                   help="also write each detected window as a labeled chunk "
                   "WAV under <dir>/<Species>/")
    add_device_arg(p)
    add_mel_args(p)
    add_encoder_args(p)
    add_batch_args(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    project_root = project_root_here()
    cfg = load_json(resolve_config(args.config or "config.json", project_root))

    if bool(args.wav) == bool(args.root):
        raise SystemExit("❌ pass exactly one of --wav (single recording) or "
                         "--root (fleet mode)")
    if args.wav:
        wavs = [Path(args.wav).expanduser().resolve()]
        if not wavs[0].exists():
            raise SystemExit(f"❌ WAV not found: {wavs[0]}")
    else:
        root = Path(args.root).expanduser().resolve()
        if not root.is_dir():
            raise SystemExit(f"❌ --root not a directory: {root}")
        wavs = sorted(root.rglob("*.wav"))
        if not wavs:
            raise SystemExit(f"❌ no .wav files under {root}")
        print(f"🎙️ fleet scan: {len(wavs)} recordings under {root}")

    session = EncoderSession(
        mel=mel_from_args(args, duration=5.0),
        encoder_dir=Path(args.encoder) if args.encoder else None,
        project_root=project_root,
        # per-window RMS fused into the device mel op instead of the host
        # prefetch thread — same math (ops.frontend.rms_scale_batch)
        normalize_on_device=not args.no_normalize,
        device=args.device,
        **session_kwargs(args),
    ).load()

    per_file, _stats = scan_soundscapes(
        wavs, session,
        detector=args.detector, config=cfg,
        hop_seconds=args.hop_seconds,
        normalize=not args.no_normalize,
    )

    score_name = "best_distance" if args.detector == "radial" else "best_score"
    out_dir = None
    if args.root and args.out:
        out_dir = Path(args.out).expanduser().resolve()
        out_dir.mkdir(parents=True, exist_ok=True)

    def fleet_key(wav: Path) -> str:
        # same-named recordings in different subdirs (siteA/x.wav, siteB/x.wav)
        # are keyed by their root-relative path, so no output overwrites another's
        if args.root:
            return "__".join(wav.relative_to(root).with_suffix("").parts)
        return wav.stem

    for wav, dets in per_file.items():
        if args.wav and args.out:
            out = Path(args.out)
        elif out_dir is not None:
            out = out_dir / (fleet_key(wav) + ".detections.csv")
        else:
            out = wav.with_suffix(".detections.csv")
        write_detections_csv(dets, out, score_name)
        print(f"💾 detections: {out}")

    if args.extract_dir:
        for wav, dets in per_file.items():
            extract_detected_chunks(wav, dets, Path(args.extract_dir), sr=session.mel.sr, stem=fleet_key(wav))

    counts = Counter(d.species or "NO_DETECT" for dets in per_file.values() for d in dets)
    for sp, n in counts.most_common():
        print(f"  {sp:30s} {n:6d} windows")


if __name__ == "__main__":
    main()
