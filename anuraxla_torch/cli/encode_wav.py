"""``encode-wav`` on the port — encode one WAV to its latent vector and print
it (the reference's ``07_encode_wav_to_latent.py``, as
``anuraxla/cli/encode_wav.py``: text or JSONL output, duration default 3.0 s).

``--auto-frames`` takes target_frames and n_mels from the encoder artifact's
input shape. ``--root`` batch-encodes a folder tree to JSONL; ``--parquet``
also writes a features table (z0..zD-1 + label/file; needs pandas, imported
only then). Encoding runs on the card unless ``--device cpu``.

    python -m anuraxla_torch encode-wav --wav clip.wav --jsonl
    python -m anuraxla_torch encode-wav --root val_chunks --jsonl --duration 5
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from anuraxla_torch.cli.common import (
    add_batch_args, add_device_arg, add_encoder_args, add_mel_args, mel_from_args, project_root_here, session_kwargs,
)
from anuraxla_torch.models.checkpoint import load_or_init_encoder
from anuraxla_torch.pipeline.dataset import load_wav_batch, scan_species_tree
from anuraxla_torch.pipeline.session import EncoderSession


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--wav", type=str, help="single wav to encode")
    g.add_argument("--root", type=str, help="folder tree to batch-encode to JSONL")
    add_device_arg(p)
    add_encoder_args(p)
    add_batch_args(p)
    add_mel_args(p, duration_default=3.0)  # duration 3.0: the reference 07 default
    p.add_argument("--auto-frames", action="store_true",
                   help="take target_frames from the encoder artifact's input shape")
    p.add_argument("--jsonl", action="store_true")
    p.add_argument("--parquet", type=str, default=None,
                   help="with --root: also write a features parquet "
                   "(z0..zD-1 columns + label/file), the artifact format the "
                   "reference's print-latents tool reads")
    p.add_argument("--precision", type=int, default=6)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    project_root = project_root_here()
    if args.parquet:
        try:
            import pandas as pd
        except ImportError as e:
            raise SystemExit(f"❌ --parquet needs pandas, which is not installed ({e})") from e

    mel = mel_from_args(args, duration=args.duration)
    session = EncoderSession(
        mel=mel,
        encoder_dir=Path(args.encoder) if args.encoder else None,
        project_root=project_root,
        device=args.device,
        **session_kwargs(args),
    )
    if args.auto_frames:
        _, cfg = load_or_init_encoder(session.encoder_dir, project_root)
        t, m = cfg.input_hw
        session.mel = mel.replace(target_frames=t, n_mels=m)
        print(f"🔍 auto-frames: encoder expects (T={t}, M={m})", file=sys.stderr)
    session.load()

    def emit(path: Path, z: np.ndarray, index: int = 0, label: str | None = None):
        if args.jsonl:
            print(json.dumps({
                "index": index, "file": str(path), "label": label,
                "dim": int(z.shape[0]),
                "vector": [round(float(v), args.precision) for v in z],
            }))
        else:
            print(f"📄 {path}")
            print(f"📐 latent dim: {z.shape[0]}")
            np.set_printoptions(precision=args.precision, suppress=True, linewidth=160)
            print(z)

    if args.wav:
        wav = Path(args.wav).expanduser().resolve()
        if not wav.exists():
            raise SystemExit(f"❌ WAV not found: {wav}")
        batch = load_wav_batch([wav], sr=session.mel.sr, num_samples=session.mel.num_samples)
        if not batch.ok[0]:
            raise SystemExit(f"❌ cannot decode: {batch.errors[0]}")
        emit(wav, session.encode_array(batch.audio)[0])
        return

    root = Path(args.root).expanduser().resolve()
    if not root.exists():
        raise SystemExit(f"❌ root not found: {root}")
    idx = 0
    records = []
    for sp, wavs in scan_species_tree(root).items():
        if not wavs:
            continue
        Z, ok, errors = session.encode_paths(wavs)
        for j, w in enumerate(wavs):
            if ok[j]:
                emit(w, Z[j], index=idx, label=sp)
                if args.parquet:
                    records.append((str(w), sp, Z[j]))
            else:
                print(f"⚠️ {w}: {errors[j]}", file=sys.stderr)
            idx += 1

    if args.parquet and records:
        D = records[0][2].shape[0]
        df = pd.DataFrame(
            {
                "file": [r[0] for r in records],
                "label": [r[1] for r in records],
                **{f"z{i}": [float(r[2][i]) for r in records] for i in range(D)},
            }
        )
        out = Path(args.parquet).expanduser().resolve()
        out.parent.mkdir(parents=True, exist_ok=True)
        df.to_parquet(out)
        print(f"💾 features parquet: {out} ({len(df)} rows, D={D})", file=sys.stderr)


if __name__ == "__main__":
    main()
