"""``evaluate-wav`` on the port — detect species in one WAV with the radial
detector (reference ``09_evaluate_wav_detection.py``: accept iff
||z − mu_k|| <= rk, priority tie-break; exit code 0 = detected, 2 = not).

``detect_species()`` is the library entry; it takes a loaded session so the
encoder is never reloaded per call. ``--config`` resolves against the
project root (``cli.common.resolve_config``); the encoder is ``--encoder``,
else the project's default artifact, else a seeded init (``--init-seed``).

    python -m anuraxla_torch.cli.evaluate_wav --wav clip.wav --config config.json
    python -m anuraxla_torch.cli.evaluate_wav --wav clip.wav --serving-tier fast

``--serving-tier`` (parity / balanced / fast) bundles the frontend mode, the
frontend backend and the encoder dtype; ``--fast-frontend``,
``--frontend-backend`` and ``--encoder-dtype`` override it when typed
(``cli/common.py``).
"""

from __future__ import annotations

import argparse
import itertools
import sys
from pathlib import Path
from typing import Optional, Tuple

import torch

from anuraxla_torch.cli.common import (
    add_batch_args, add_device_arg, add_encoder_args, add_mel_args, mel_from_args, project_root_here, resolve_config,
    session_kwargs,
)
from anuraxla_torch.config import get_chunk_seconds, load_config, priority_ranks, read_radial
from anuraxla_torch.detect.radial import radial_decide
from anuraxla_torch.pipeline.dataset import load_wav_batch
from anuraxla_torch.pipeline.session import EncoderSession
from anuraxla_torch.utils.timing import span

_requests = itertools.count()  # a span's id: the request's number in this process


def detect_species(
    wav_path: str | Path,
    session: EncoderSession,
    config_path: str | Path,
) -> Tuple[bool, Optional[str], float]:
    """-> (detected, species|None, best_distance)."""
    with span("request", id=next(_requests)):
        with span("config_read"):
            cfg = load_config(Path(config_path))
            species, centroids, thresholds, chunk_seconds = read_radial(cfg)
        session.reconfigure(duration=chunk_seconds)
        batch = load_wav_batch([Path(wav_path)], sr=session.mel.sr, num_samples=session.mel.num_samples)
        if not batch.ok[0]:
            raise FileNotFoundError(f"cannot read WAV: {wav_path} ({batch.errors[0]})")
        Z = torch.from_numpy(session.encode_array(batch.audio))
        det, win, best = radial_decide(
            Z, torch.from_numpy(centroids), torch.from_numpy(thresholds),
            torch.from_numpy(priority_ranks(species)),
        )
        detected = bool(det[0])
        sp = species[int(win[0])] if detected else None
        return detected, sp, float(best[0])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav", required=True, type=str)
    p.add_argument("--config", type=str, default="config.json")
    add_device_arg(p)
    p.add_argument("--init-seed", type=int, default=0, help="seed of the encoder's random init (no artifact)")
    add_mel_args(p)
    add_encoder_args(p)
    add_batch_args(p)
    p.set_defaults(batch_size=1)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    project_root = project_root_here()
    cfg_path = resolve_config(args.config, project_root)
    wav = Path(args.wav).expanduser().resolve()
    if not wav.exists():
        raise SystemExit(f"❌ WAV not found: {wav}")
    mel = mel_from_args(args, get_chunk_seconds(load_config(cfg_path)))
    session = EncoderSession(
        mel=mel, device=args.device, init_seed=args.init_seed, project_root=project_root,
        encoder_dir=Path(args.encoder) if args.encoder else None, **session_kwargs(args),
    ).load()
    detected, sp, best_d = detect_species(wav, session, cfg_path)
    if detected:
        print(f"✅ DETECTED: {sp} | best_distance={best_d:.6f}")
        sys.exit(0)
    print(f"❌ NO DETECT | best_distance={best_d:.6f}")
    sys.exit(2)


if __name__ == "__main__":
    main()
