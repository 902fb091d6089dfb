"""``make-synth-data`` on the port — a copy of ``anuraxla/cli/make_synth_data.py``
(the port imports nothing of ``anuraxla``): the same seed writes the same
bytes.

Generate a synthetic labeled chunk tree (train/val/test) for tests, bench,
and end-to-end drives. Each species gets a distinct band-limited "call"
(FM tone burst + noise) so latent clusters separate even under an untrained
encoder. Not a reference component — the reference assumes pre-extracted
chunks exist; this makes the framework self-exercising.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from anuraxla_torch.constants import SPECIES
from anuraxla_torch.utils.wavio import write_wav


def synth_call(rng: np.random.Generator, sr: int, seconds: float, f0: float, fm: float) -> np.ndarray:
    n = int(sr * seconds)
    t = np.arange(n) / sr
    # pulsed FM carrier: species-specific base freq + pulse rate
    carrier = np.sin(2 * np.pi * (f0 * t + 20.0 * np.sin(2 * np.pi * fm * t)))
    pulses = (np.sin(2 * np.pi * (fm / 3.0) * t) > 0).astype(np.float32)
    call = 0.25 * carrier * pulses
    noise = 0.02 * rng.standard_normal(n)
    return (call + noise).astype(np.float32)


def make_tree(
    root: Path,
    *,
    sr: int = 48000,
    seconds: float = 5.0,
    per_species: int = 12,
    splits=("train_chunks", "val_chunks", "test_chunks"),
    species=SPECIES,
    seed: int = 0,
) -> None:
    rng = np.random.default_rng(seed)
    base_freqs = np.linspace(400, 6000, len(species))
    pulse_rates = np.linspace(4, 16, len(species))
    for split in splits:
        for k, sp in enumerate(species):
            d = Path(root) / split / sp
            d.mkdir(parents=True, exist_ok=True)
            for i in range(per_species):
                y = synth_call(rng, sr, seconds, float(base_freqs[k]), float(pulse_rates[k]))
                write_wav(d / f"audio{i:03d}_chunk0.wav", y, sr, subtype="PCM_16")


def make_soundscape(
    out: Path,
    *,
    sr: int = 48000,
    minutes: float = 30.0,
    plants=((0, 600.0),),
    call_seconds: float = 4.0,
    snr_db: float | None = None,
    seed: int = 0,
) -> list:
    """Write a long synthetic field recording with planted calls — the
    reproducible drive behind the soundscape-scan and noise-robustness
    baselines (BASELINE.md r3/r4 scan rows).

    ``plants`` is a list of (species_index, t_start_seconds); each plants
    that species' call (same per-species FM/pulse parameters as
    :func:`make_tree`, same fixed call seed as the planted-call tests, so a
    fitted detector from the tree matches what's planted). ``snr_db``
    scales the broadband background noise so that 20·log10(rms_call /
    rms_noise) equals it over the call extent (None = a faint 0.001-sigma
    bed like the clean-scan tests). Returns the plant list actually used.
    """
    rng = np.random.default_rng(seed)
    n = int(sr * minutes * 60.0)
    base_freqs = np.linspace(400, 6000, len(SPECIES))
    pulse_rates = np.linspace(4, 16, len(SPECIES))
    # one representative call fixes the SNR scale (all species' calls share
    # the same 0.25-amplitude pulsed-carrier envelope)
    probe = synth_call(np.random.default_rng(3), sr, call_seconds, float(base_freqs[0]), float(pulse_rates[0]))
    rms_call = float(np.sqrt(np.mean(probe**2)))
    sigma = 0.001 if snr_db is None else rms_call / (10.0 ** (snr_db / 20.0))
    y = (sigma * rng.standard_normal(n)).astype(np.float32)
    used = []
    for k, t0 in plants:
        i0 = int(round(t0 * sr))
        call = synth_call(
            np.random.default_rng(3), sr, call_seconds,
            float(base_freqs[int(k)]), float(pulse_rates[int(k)]),
        )
        if i0 < 0 or i0 + call.shape[0] > n:
            raise SystemExit(f"❌ plant {k}@{t0}s falls outside the {minutes}-min recording")
        y[i0 : i0 + call.shape[0]] += call
        used.append((int(k), float(t0)))
    np.clip(y, -1.0, 1.0, out=y)
    out.parent.mkdir(parents=True, exist_ok=True)
    write_wav(out, y, sr, subtype="PCM_16")
    return used


def _parse_plant(s: str):
    k, _, t = s.partition("@")
    return int(k), float(t)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", type=str, default=None)
    p.add_argument("--sr", type=int, default=48000)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--per-species", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--soundscape", type=str, default=None, metavar="OUT.wav",
                   help="write a long synthetic field recording with planted "
                   "calls instead of a chunk tree (the reproducible scan/"
                   "robustness drive)")
    p.add_argument("--minutes", type=float, default=30.0)
    p.add_argument("--plant", type=_parse_plant, action="append", default=None,
                   metavar="SPECIES_IDX@SECONDS",
                   help="plant species k's call at t seconds (repeatable; "
                   "default 0@600)")
    p.add_argument("--call-seconds", type=float, default=4.0)
    p.add_argument("--snr-db", type=float, default=None,
                   help="background broadband noise level as an SNR (dB) vs "
                   "the planted call's RMS (default: faint 0.001-sigma bed)")
    args = p.parse_args(argv)
    if args.soundscape:
        used = make_soundscape(
            Path(args.soundscape), sr=args.sr, minutes=args.minutes,
            plants=args.plant or [(0, 600.0)], call_seconds=args.call_seconds,
            snr_db=args.snr_db, seed=args.seed,
        )
        snr = "clean bed" if args.snr_db is None else f"{args.snr_db:g} dB SNR"
        print(
            f"✅ soundscape at {args.soundscape} ({args.minutes:g} min @ "
            f"{args.sr} Hz, {snr}, plants: "
            + ", ".join(f"{SPECIES[k]}@{t:g}s" for k, t in used)
            + ")"
        )
        return
    if not args.root:
        raise SystemExit("❌ --root is required (or use --soundscape)")
    make_tree(
        Path(args.root), sr=args.sr, seconds=args.seconds,
        per_species=args.per_species, seed=args.seed,
    )
    # a config.json seed so fit scripts can run immediately
    import json

    cfg_path = Path(args.root) / "config.json"
    if not cfg_path.exists():
        cfg_path.write_text(json.dumps({"species": list(SPECIES), "chunk_seconds": args.seconds}, indent=2))
    print(f"✅ synthetic tree at {args.root} ({args.per_species}/species/split, {args.seconds}s @ {args.sr}Hz)")


if __name__ == "__main__":
    main()
