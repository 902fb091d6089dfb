"""``evaluate-wav-map`` on the port — detect species in one WAV with the
Gaussian MAP detector (the reference's ``09n_evaluate_wav_detection.py``, as
``anuraxla/cli/evaluate_wav_map.py``: argmax of log N(z|mu_k,Sigma_k) +
log pi_k with tau rejection; exit 0 detected / 2 not). The same flags as the
reference: no serving tier, so the session runs the port's defaults (the
exact mel kernel, f32 encoder) on the card unless ``--device cpu``.

    python -m anuraxla_torch.cli.evaluate_wav_map --wav clip.wav --config config.json
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Tuple

import torch

from anuraxla_torch.cli.common import (
    add_device_arg, add_encoder_args, add_mel_args, mel_from_args, project_root_here, resolve_config,
)
from anuraxla_torch.config import load_config, read_map
from anuraxla_torch.detect.gaussian_map import map_decide
from anuraxla_torch.pipeline.dataset import load_wav_batch
from anuraxla_torch.pipeline.session import EncoderSession


def detect_species_map(
    wav_path: str | Path,
    session: EncoderSession,
    config_path: str | Path,
) -> Tuple[bool, Optional[str], float]:
    """-> (detected, species|None, best_score)."""
    species, means, precs, lds, priors, tau, chunk_seconds = read_map(load_config(Path(config_path)))
    session.reconfigure(duration=chunk_seconds)
    batch = load_wav_batch([Path(wav_path)], sr=session.mel.sr, num_samples=session.mel.num_samples)
    if not batch.ok[0]:
        raise FileNotFoundError(f"cannot read WAV: {wav_path} ({batch.errors[0]})")
    Z = torch.from_numpy(session.encode_array(batch.audio))
    tau_t = torch.tensor(float("nan") if tau is None else tau, dtype=torch.float32)
    det, win, best = map_decide(Z, *(torch.from_numpy(a) for a in (means, precs, lds, priors)), tau_t)
    detected = bool(det[0])
    sp = species[int(win[0])] if detected else None
    return detected, sp, float(best[0])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav", required=True, type=str)
    p.add_argument("--config", type=str, default=None)
    add_device_arg(p)
    add_mel_args(p)
    add_encoder_args(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    project_root = project_root_here()
    cfg_path = resolve_config(args.config or "config.json", project_root)
    wav = Path(args.wav).expanduser()
    if not wav.is_absolute():
        wav = (Path.cwd() / wav).resolve()
    if not wav.exists():
        raise SystemExit(f"❌ WAV not found: {wav}")
    # MAP chunk_seconds resolution chain (map meta -> global) before the session
    try:
        chunk_seconds = read_map(load_config(cfg_path))[6]
    except ValueError:
        chunk_seconds = 5.0
    session = EncoderSession(
        mel=mel_from_args(args, duration=chunk_seconds),
        encoder_dir=Path(args.encoder) if args.encoder else None,
        project_root=project_root,
        batch_size=1,
        device=args.device,
    ).load()
    detected, sp, best = detect_species_map(wav, session, cfg_path)
    if detected:
        print(f"✅ DETECTED (MAP): {sp} | best_score={best:.6f}")
        sys.exit(0)
    print(f"❌ NO_DETECT (MAP) | best_score={best:.6f}")
    sys.exit(2)


if __name__ == "__main__":
    main()
