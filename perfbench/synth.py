"""Traffic inputs made from a seed: labelled chunk trees and long field
recordings with planted calls, written as PCM16 mono WAVs.

``call_template``, ``BASE_FREQS`` and ``PULSE_RATES`` are frozen copies of
``anuraxla_torch/cli/make_synth_data.py`` (``synth_call``'s carrier and
pulses, the per-species constants of ``make_tree`` / ``make_soundscape``): a
species' call is its pulsed FM carrier. The writers below are this benchmark's own: the noise is
drawn in a few large calls from one ``torch.Generator`` on the device the run
uses, the draws of labels, shifts and gains from one ``numpy`` generator, so
a seed gives the same files. Every seed gives the same sizes, the same number
of files of each kind and the same number of planted calls; only their
contents and order differ.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

SPECIES = ("Batrachyla_leptopus", "Batrachyla_taeniata", "Calyptocephalella_gayi", "Pleurodema_thaul")
BASE_FREQS = np.linspace(400, 6000, len(SPECIES))
PULSE_RATES = np.linspace(4, 16, len(SPECIES))
NOISE_SIGMA = 0.02  # make_synth_data's noise under each call
ROWS_A_DRAW = 256  # rows of noise drawn by one call of the generator


def call_template(k: int, sr: int, seconds: float) -> np.ndarray:
    """Species ``k``'s call: ``make_synth_data.synth_call`` (frozen here) without
    its noise term, which ``chunk_tree`` draws on the device instead."""
    n = int(sr * seconds)
    t = np.arange(n) / sr
    f0, fm = float(BASE_FREQS[k]), float(PULSE_RATES[k])
    carrier = np.sin(2 * np.pi * (f0 * t + 20.0 * np.sin(2 * np.pi * fm * t)))
    pulses = (np.sin(2 * np.pi * (fm / 3.0) * t) > 0).astype(np.float32)
    return (0.25 * carrier * pulses).astype(np.float32)


def wav_header(n_samples: int, sr: int) -> bytes:
    """The 44-byte header of a PCM16 mono WAV of ``n_samples`` samples."""
    data = 2 * n_samples
    return (b"RIFF" + struct.pack("<I", 36 + data) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, 2 * sr, 2, 16)
            + b"data" + struct.pack("<I", data))


def to_pcm16(y: torch.Tensor) -> np.ndarray:
    """f32 samples -> int16 host array: clip(round(y * 32768)), as a PCM16 writer does."""
    return torch.clamp(torch.round(y * 32768.0), -32768, 32767).to(torch.int16).cpu().numpy()


def write_pcm16(path: Path, samples: np.ndarray, sr: int) -> None:
    with open(path, "wb") as f:
        f.write(wav_header(samples.shape[0], sr))
        f.write(samples.astype("<i2", copy=False).tobytes())


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def chunk_tree(root: Path, mix: dict, seed: int, device: torch.device, *, sr: int, seconds: float) -> List[dict]:
    """A labelled tree ``root/<Species>/c<i>.wav`` of ``mix["per_species"]``
    files a species. ``mix["distractor_share"]`` of each folder's files hold
    no call, only noise and a tone at a random frequency; the others hold
    their folder's call, circularly shifted and scaled by a gain from
    ``mix["gain"]``. -> one dict a file: path, species index, has_call."""
    rng = np.random.default_rng([int(seed), 1])
    n_sp, per = int(mix.get("species", len(SPECIES))), int(mix["per_species"])
    n = int(sr * seconds)
    n_distract = int(round(per * float(mix["distractor_share"])))
    lo, hi = mix["gain"]
    tmpl = torch.from_numpy(np.stack([np.tile(call_template(k, sr, seconds), 2) for k in range(n_sp)])).to(device)
    t = torch.arange(n, device=device, dtype=torch.float32) / sr
    files = []
    for k in range(n_sp):
        kinds = np.zeros(per, bool)
        kinds[rng.permutation(per)[: per - n_distract]] = True
        for i in range(per):
            files.append({"path": Path(root) / SPECIES[k] / f"c{i:05d}.wav", "species": k, "has_call": bool(kinds[i]),
                          "shift": int(rng.integers(0, n)), "gain": float(rng.uniform(lo, hi)),
                          "tone_hz": float(rng.uniform(*mix["tone_hz"]))})
    for k in range(n_sp):
        (Path(root) / SPECIES[k]).mkdir(parents=True, exist_ok=True)
    g = generator(seed, device)
    for b0 in range(0, len(files), ROWS_A_DRAW):
        block = files[b0 : b0 + ROWS_A_DRAW]
        y = NOISE_SIGMA * torch.randn((len(block), n), generator=g, device=device)
        for j, f in enumerate(block):
            if f["has_call"]:
                y[j] += f["gain"] * tmpl[f["species"], f["shift"] : f["shift"] + n]
            else:
                y[j] += 0.5 * f["gain"] * 0.25 * torch.sin(2 * np.pi * f["tone_hz"] * t)
        pcm = to_pcm16(y)
        for j, f in enumerate(block):
            write_pcm16(f["path"], pcm[j], sr)
    return files


def soundscapes(root: Path, mix: dict, seed: int, device: torch.device, *, sr: int) -> List[dict]:
    """``mix["recordings"]`` recordings of ``mix["seconds"]`` s, a noise bed of
    ``mix["bed_sigma"]`` with ``mix["calls_per_recording"]`` planted calls of
    ``mix["call_seconds"]`` s each, the species in turn from a first drawn
    from the seed, each start drawn within its own slot of a grid of
    ``call_seconds + gap`` slots (calls never overlap). -> one dict
    a recording: path, samples, plants [(species, start sample)]."""
    rng = np.random.default_rng([int(seed), 2])
    n = int(sr * float(mix["seconds"]))
    call_n = int(sr * float(mix["call_seconds"]))
    slot = int(sr * (float(mix["call_seconds"]) + float(mix["gap_seconds"])))
    n_slots = n // slot
    per = int(mix["calls_per_recording"])
    if per > n_slots:
        raise ValueError(f"{per} calls do not fit {n_slots} slots of a recording")
    tmpl = [torch.from_numpy(call_template(k, sr, float(mix["call_seconds"]))).to(device) for k in range(len(SPECIES))]
    Path(root).mkdir(parents=True, exist_ok=True)
    g = generator(seed, device)
    out = []
    for r in range(int(mix["recordings"])):
        y = float(mix["bed_sigma"]) * torch.randn(n, generator=g, device=device)
        plants = []
        offset = int(rng.integers(0, len(SPECIES)))  # the species take turns: each seed plants as many of each
        for j, s in enumerate(np.sort(rng.permutation(n_slots)[:per])):
            k = (j + offset) % len(SPECIES)
            start = int(s) * slot + int(rng.integers(0, slot - call_n + 1))
            y[start : start + call_n] += tmpl[k]
            plants.append((k, start))
        path = Path(root) / f"rec{r:03d}.wav"
        write_pcm16(path, to_pcm16(torch.clamp(y, -1.0, 1.0)), sr)
        out.append({"path": path, "samples": n, "plants": plants})
    return out


def by_species(files: Sequence[dict], n_sp: int) -> Dict[int, List[dict]]:
    out: Dict[int, List[dict]] = {k: [] for k in range(n_sp)}
    for f in files:
        out[f["species"]].append(f)
    return out
