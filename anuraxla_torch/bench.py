"""Throughput of the served pipeline on one card — the port of the
reference's ``bench.py`` (``bench_tpu_pipeline``): audio chunks encoded and
detected per second, device-resident.

    python -m anuraxla_torch.bench [--batch 1024] [--measure-s 2.5] [--device cuda]

The pipeline is the production path as ONE batched function over 5 s, 48 kHz
chunks already on the device: RMS scale (over the valid region) -> fused mel
kernel -> dB / standardize / crop -> conv-VAE encode -> radial detect. Three
legs, the serving tiers' operating points:

- ``value``: the exact-f32 mel kernel on pre-padded rows + the bf16-trunk
  encoder (the balanced tier);
- ``value_f32_encoder``: the same with the all-f32 encoder (the parity tier);
- ``value_fast_tier``: the crop-first frontend + the bf16 mel mode + the
  bf16 trunk (the fast tier), on raw rows.

Every leg warms up with an untimed group, then measures windows of
``--measure-s`` seconds until two consecutive windows agree within 10 %
(budget-capped; the best window and ``converged: false`` otherwise). The raw
per-window rates are printed for audit. Host decode and the host -> device
copy are not in this figure: ``chip_smoke.py`` times ``encode_array`` with
them.

Prints ONE JSON line. The reference's ``vs_baseline`` is not carried over: its
pinned denominator was measured on another machine's CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from anuraxla_torch import resolve_device
from anuraxla_torch.constants import DEFAULT_MEL, MelConfig
from anuraxla_torch.detect.radial import radial_decide
from anuraxla_torch.models.vae import VAEConfig
from anuraxla_torch.ops.frontend import log_mel_batch, mel_to_encoder_input, rms_scale_batch
from anuraxla_torch.probes.common import detector_tables, device_header, pre_padded_rows, seeded_encoder

FETCH_GROUP = 8  # batches per fetched digest
WINDOW_SECONDS = 2.5  # one measurement window (adaptive_rate)
WINDOW_TOL = 0.10  # two consecutive windows within 10% = converged
MAX_LEG_SECONDS = 120.0  # measurement budget per leg
# NVIDIA H100 SXM, published dense peaks (data sheet): FP32 outside the tensor
# cores (the exact mel kernel's FFMA loops) and bf16 on them (the bf16 trunk)
H100_PEAK_FP32_FLOPS = 67e12
H100_PEAK_BF16_FLOPS = 989e12
KERNEL_TILE_FRAMES = 32  # frames a block of csrc/mel_power_ct.cu owns


def pipeline_flops(mel: MelConfig, vcfg: VAEConfig) -> dict:
    """Hand-derived FLOPs per chunk (FLOP = 2·MAC) in two accountings:

    - ``dense_equiv``: the useful math a dense windowed-DFT implementation
      does for the same result (frames × [2·n_fft·n_freq DFT + mel]) over the
      clip's real frames — the figure a dense-formulation reader expects;
    - ``kernel_actual``: the FP32 MACs the port's exact Cooley–Tukey kernel
      executes in its GEMM form — conjugate-symmetry-halved outer products,
      the merged filterbank and the literal-weight count of the inner stage,
      over the frames its 32-frame tiles compute (one FP32 pass: no split).

    Both include the conv-VAE encoder and omit detect (< 0.1 %)."""
    n_fft, hop, n_mels = mel.n_fft, mel.hop_length, mel.n_mels
    n_freq = n_fft // 2 + 1
    frames = mel.num_samples // hop + 1
    dense_equiv = frames * 2 * (2 * n_fft * n_freq + n_freq * n_mels)

    t_pad = -(-frames // KERNEL_TILE_FRAMES) * KERNEL_TILE_FRAMES
    R = n_fft // 128
    macs = 0
    for r in range(R // 2 + 1):
        real = r == 0 or 2 * r == R  # a_im is exactly zero at r = 0 and R/2
        macs += (2 if real else 4) * 128 * 128 + 128 * n_mels + R * 128 * (1 if real else 2)
    kernel_actual = t_pad * 2 * macs

    t, m, cin = *vcfg.input_hw, 1
    enc_macs = 0
    for w in vcfg.widths:  # stride-2 k3 conv + stride-1 k3 conv per block
        t, m = -(-t // 2), -(-m // 2)
        enc_macs += t * m * 9 * cin * w + t * m * 9 * w * w
        cin = w
    enc_macs += t * m * cin * vcfg.dense_width
    enc_macs += 2 * vcfg.dense_width * vcfg.latent_dim  # mu + logvar heads
    enc = 2 * enc_macs
    return {"dense_equiv": dense_equiv + enc, "kernel_actual": kernel_actual + enc}


def make_audio(batch: int, num_samples: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    t = np.arange(num_samples) / 48_000
    base = 0.2 * np.sin(2 * np.pi * 2000.0 * t)
    out = np.empty((batch, num_samples), np.float32)
    for i in range(batch):
        out[i] = base + 0.02 * rng.standard_normal(num_samples)
    return out


def adaptive_rate(run_group, units_per_group: float, *, window_s: float = WINDOW_SECONDS,
                  tol: float = WINDOW_TOL, max_s: float = MAX_LEG_SECONDS):
    """Adaptive-window throughput. ``run_group()`` starts one group of batches
    and returns a digest whose ``float()`` waits for the whole group (on a
    card: a read that synchronizes the stream). Groups are dispatched two
    deep, so the wait overlaps the next group's enqueue. Windows of
    ``window_s`` seconds are measured until two consecutive windows agree
    within ``tol``; past ``max_s`` the best window is returned with
    ``converged=False``. -> (rate, window_rates, converged)."""
    float(run_group())  # untimed: builds, tables, allocator, cuDNN's choices

    windows: list[float] = []
    budget_t0 = time.perf_counter()
    while True:
        groups = 0
        t0 = time.perf_counter()
        prev = run_group()
        while True:
            cur = run_group()
            float(prev)
            prev = cur
            groups += 1
            if time.perf_counter() - t0 >= window_s and groups >= 2:
                break
        float(prev)
        groups += 1
        dt = time.perf_counter() - t0
        windows.append(units_per_group * groups / dt)
        if len(windows) >= 2:
            a, b = windows[-2], windows[-1]
            if abs(a - b) / max(a, b) <= tol:
                return (a + b) / 2.0, windows, True
        if time.perf_counter() - budget_t0 >= max_s:
            return max(windows), windows, False


def bench_pipeline(audio: np.ndarray, batch: int, backend: str = "cuda", encoder_dtype: str = "bfloat16",
                   parity: bool = True, device="cuda", *, mel: MelConfig = DEFAULT_MEL,
                   window_s: float = WINDOW_SECONDS, max_s: float = MAX_LEG_SECONDS):
    """One leg: chunks/s of the device-resident pipeline -> (rate,
    window_rates, converged). Rows arrive in the kernel's pre-padded layout
    where the leg allows it (parity, the exact kernel, hop % 128 == 0): the
    loader writes decoded samples into a row either way, so the offset costs
    the host nothing and the device skips a signal-sized pad. The fast leg
    takes raw rows."""
    dev = resolve_device(device)
    vcfg = dataclasses.replace(VAEConfig(), input_hw=(mel.target_frames, mel.n_mels), dtype=encoder_dtype)
    enc = seeded_encoder(vcfg, dev)
    centroids, thresholds, ranks = detector_tables(vcfg.latent_dim, dev)

    pre_padded = parity and backend == "cuda" and mel.hop_length % 128 == 0
    host, pad_l = pre_padded_rows(mel, audio[:batch]) if pre_padded else (audio[:batch], 0)
    a = torch.from_numpy(np.ascontiguousarray(host)).to(dev)

    def pipeline(y):
        # the scale reduces over the sliced valid region: bitwise the unpadded
        # path's scale, and fewer bytes than reducing the padded rows
        scale = rms_scale_batch(y[:, pad_l : pad_l + mel.num_samples])
        mels = log_mel_batch(y, mel, parity=parity, backend=backend, rms_scale=scale, pre_padded=pre_padded)
        z = enc(mel_to_encoder_input(mels))["mu"]
        _, winner, best = radial_decide(z, centroids, thresholds, ranks)
        return best.sum() + winner.sum()  # a digest that depends on every row

    def run_group():
        with torch.inference_mode():
            acc = pipeline(a)
            for _ in range(FETCH_GROUP - 1):
                acc = acc + pipeline(a)
        return acc

    return adaptive_rate(run_group, batch * FETCH_GROUP, window_s=window_s, max_s=max_s)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu (the plain versions)")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--measure-s", type=float, default=WINDOW_SECONDS, help="seconds per measurement window")
    p.add_argument("--max-leg-s", type=float, default=MAX_LEG_SECONDS, help="measurement budget per leg")
    p.add_argument("--duration", type=float, default=DEFAULT_MEL.duration, help="seconds of audio a chunk")
    p.add_argument("--target-frames", type=int, default=DEFAULT_MEL.target_frames)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    mel = DEFAULT_MEL.replace(duration=args.duration, target_frames=args.target_frames)
    audio = make_audio(args.batch, mel.num_samples)
    kw = dict(device=dev, mel=mel, window_s=args.measure_s, max_s=args.max_leg_s)

    legs = {  # name -> (backend, encoder_dtype, parity)
        "balanced": ("cuda", "bfloat16", True),
        "f32_encoder": ("cuda", "float32", True),
        "fast_tier": ("cuda-bf16", "bfloat16", False),
    }
    out = {name: bench_pipeline(audio, args.batch, backend, dtype, parity, **kw)
           for name, (backend, dtype, parity) in legs.items()}

    rate = out["balanced"][0]
    fl = pipeline_flops(mel, dataclasses.replace(VAEConfig(), input_hw=(mel.target_frames, mel.n_mels)))
    print(json.dumps({
        "metric": "chunks_encoded_detected_per_sec_per_card",
        "value": rate,
        "unit": "chunks/s",
        "value_f32_encoder": out["f32_encoder"][0],
        "value_fast_tier": out["fast_tier"][0],
        "fast_tier_backend": legs["fast_tier"][0],
        "batch": args.batch,
        "chunk_seconds": mel.duration,
        **device_header(dev),
        "tflops_kernel_actual": rate * fl["kernel_actual"] / 1e12,
        "tflops_dense_equiv": rate * fl["dense_equiv"] / 1e12,
        "peak_tflops_fp32_h100": H100_PEAK_FP32_FLOPS / 1e12,
        "peak_tflops_bf16_h100": H100_PEAK_BF16_FLOPS / 1e12,
        "converged": {name: leg[2] for name, leg in out.items()},
        "windows": {name: leg[1] for name, leg in out.items()},
    }))


if __name__ == "__main__":
    main()
