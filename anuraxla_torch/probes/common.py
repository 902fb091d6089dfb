"""Shared measurement harness of the probes — the port of
``scripts/_probe_common.py``.

The reference amortizes a device->host round trip of its relay over groups of
calls; nothing of the kind stands between this host and its card, so that
scheme is not carried over. On the card a time is the device's own: CUDA
events around a group of calls, after a warm-up that builds the kernel and its
tables. On the CPU (``--device cpu``, where the plain PyTorch versions run) it
is the host's clock, and says nothing about the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from anuraxla_torch import resolve_device
from anuraxla_torch.cli.common import add_mel_args, mel_from_args
from anuraxla_torch.constants import MelConfig
from anuraxla_torch.models.vae import ConvVAEEncoder, VAEConfig, init_encoder_params

GROUP = 4  # calls between two CUDA events


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure_ms(fn, arg, measure_s: float = 4.0, device="cuda") -> float:
    """ms per ``fn(arg)`` call: one untimed call (build, tables, allocator),
    then groups of ``GROUP`` calls until ``measure_s`` seconds have passed (at
    least one group). Device time on a card, host time on the CPU."""
    on_card = torch.device(device).type == "cuda"
    fn(arg)
    if on_card:
        torch.cuda.synchronize()
    calls, total_ms = 0, 0.0
    t0 = time.perf_counter()
    while True:
        if on_card:
            total_ms += GROUP * cuda_ms(lambda: fn(arg), iters=GROUP, warmup=0)
        else:
            t = time.perf_counter()
            for _ in range(GROUP):
                fn(arg)
            total_ms += (time.perf_counter() - t) * 1e3
        calls += GROUP
        if time.perf_counter() - t0 >= measure_s:
            return total_ms / calls


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def device_header(dev: torch.device) -> dict:
    """What every probe prints first: where its numbers were taken."""
    if dev.type == "cuda":
        return {"device": torch.cuda.get_device_name(dev), "card": card_line()}
    return {"device": "cpu", "card": None, "note": "host-clock times of the plain versions; not a device metric"}


def parser(description: str) -> argparse.ArgumentParser:
    """The options every probe takes: the device, the batch, the measuring
    time, and the mel config (``DEFAULT_MEL`` unless flags say otherwise)."""
    p = argparse.ArgumentParser(description=description, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu (the plain versions)")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--measure-s", type=float, default=4.0, help="seconds of timed calls per measurement")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--duration", type=float, default=5.0, help="seconds of audio a row")
    add_mel_args(p)
    return p


def setup(args) -> tuple[torch.device, MelConfig]:
    return resolve_device(args.device), mel_from_args(args, args.duration)


def noise_rows(cfg: MelConfig, batch: int, seed: int) -> np.ndarray:
    """[batch, num_samples] f32 rows of 0.1-sigma noise, the probes' input."""
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((batch, cfg.num_samples))).astype(np.float32)


def pre_padded_rows(cfg: MelConfig, raw: np.ndarray) -> tuple[np.ndarray, int]:
    """``raw`` in the ct kernel's pre-padded layout -> (rows, offset of the signal)."""
    from anuraxla_torch.ops.mel_kernel import phase_padded_layout

    L_pad, pad_l = phase_padded_layout(cfg, cfg.total_frames)
    rows = np.zeros((raw.shape[0], L_pad), np.float32)
    rows[:, pad_l : pad_l + cfg.num_samples] = raw
    return rows, pad_l


def detector_tables(latent_dim: int, dev: torch.device, K: int = 4):
    """The reference probes' fixed detector: K seeded centroids, radius 3."""
    rng = np.random.default_rng(1)
    centroids = torch.from_numpy(rng.standard_normal((K, latent_dim)).astype(np.float32)).to(dev)
    return centroids, torch.full((K,), 3.0, device=dev), torch.arange(K, dtype=torch.float32, device=dev)


def seeded_encoder(vcfg: VAEConfig, dev: torch.device, seed: int = 0) -> ConvVAEEncoder:
    enc = ConvVAEEncoder(vcfg)
    enc.load_state_dict(init_encoder_params(vcfg, torch.Generator().manual_seed(seed)))
    return enc.eval().to(dev)


def max_rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |got - ref| of each row's max |ref|."""
    return float(((got - ref).abs().amax(dim=(1, 2)) / ref.abs().amax(dim=(1, 2))).max())


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)
