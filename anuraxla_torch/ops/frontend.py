"""Batched audio frontend: waveform rows -> model-ready log-mels — the port
of ``anuraxla/ops/frontend.py``.

``parity=True``: the STFT covers the full clip; the dB reference (per-row
max), the 80 dB floor and the mean/std standardization are taken over all
frames before the center crop to ``target_frames`` — the reference order.
``parity=False`` (the fast frontend): only the ``target_frames`` frames that
survive the center crop are computed, and the statistics are taken over that
cropped plane — fewer frames of work, statistically equivalent for
detection, not bit-identical to the parity order.

Backends:
- ``"cuda"``: the fused mel kernels in exact f32 (``ops.mel_kernel.mel_power``)
  — a Hopper kernel on a CUDA tensor, its plain PyTorch version on a CPU
  tensor;
- ``"cuda-bf16"``: the same kernels in their bf16 mode (one bf16 pass per
  product, f32 sums);
- ``"matmul"``: dense STFT bases + filterbank matmul in full f32;
- ``"matmul-bf16"``: the same with the matmul operands rounded to bf16.
The JAX package names its kernel backends ``pallas`` / ``pallas-bf16``; the
matmul names are shared, so a cache key also carries a framework tag
(``pipeline.session.session_fingerprint``), and it names the arithmetic that
runs (``arithmetic_backend``): a kernel backend on a CPU tensor runs the
plain version.
"""

from __future__ import annotations

import torch

from anuraxla_torch.constants import RMS_EPS, RMS_SILENCE_GATE, RMS_TARGET, MelConfig
from anuraxla_torch.ops.mel import STANDARDIZE_EPS, crop_or_pad_time, mean_std, mel_filterbank, power_to_db
from anuraxla_torch.ops.mel_kernel import apply_rms_scale, kernel_takes, mel_power, phase_padded_layout
from anuraxla_torch.ops.stft import round_bf16, stft_power
from anuraxla_torch.utils.precision import exact_f32

BACKENDS = ("cuda", "cuda-bf16", "matmul", "matmul-bf16")


def rms_normalize_batch(
    y: torch.Tensor,
    *,
    target_rms: float = RMS_TARGET,
    rms_min: float = RMS_SILENCE_GATE,
    eps: float = RMS_EPS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched RMS normalization (``00_normalize_dataset_rms.py:29-38``):
    [B, L] -> (y_norm, scaled_mask). Silent rows (rms < rms_min) pass
    through unscaled; scaled rows are clipped to [-1, 1]."""
    rms = torch.sqrt(torch.mean(y * y, dim=-1, keepdim=True))
    scaled = rms >= rms_min
    y_norm = torch.clamp(y * (target_rms / (rms + eps)), -1.0, 1.0)
    return torch.where(scaled, y_norm, y), scaled[..., 0]


def rms_scale_batch(
    y: torch.Tensor,
    *,
    target_rms: float = RMS_TARGET,
    rms_min: float = RMS_SILENCE_GATE,
    eps: float = RMS_EPS,
) -> torch.Tensor:
    """Per-row scale for ``log_mel_batch(rms_scale=...)``: s > 0 for rows to
    be clip(y·s, −1, 1)'d, s = −1 for silent rows that pass through raw —
    together exactly ``rms_normalize_batch``. For pre-padded rows pass the
    valid slice, not the padded row (the session does)."""
    rms = torch.sqrt(torch.mean(y * y, dim=-1))
    return torch.where(rms >= rms_min, target_rms / (rms + eps), torch.full_like(rms, -1.0))


def rms_normalize_np(
    y,
    *,
    target_rms: float = RMS_TARGET,
    rms_min: float = RMS_SILENCE_GATE,
    eps: float = RMS_EPS,
):
    """Numpy twin of rms_normalize_batch for host-side batch preparation."""
    import numpy as np

    rms = np.sqrt(np.mean(y * y, axis=-1, keepdims=True))
    scaled = rms >= rms_min
    y_norm = np.clip(y * (target_rms / (rms + eps)), -1.0, 1.0)
    return np.where(scaled, y_norm, y), scaled[..., 0]


def resolved_backend(cfg: MelConfig, backend: str) -> str:
    """The frontend whose math runs for (cfg, backend). Only the config gate
    carries over from the reference: a kernel backend names its matmul
    counterpart (``"cuda"`` -> ``"matmul"``, ``"cuda-bf16"`` ->
    ``"matmul-bf16"``, which keeps the reduced-precision intent) for a config
    no kernel takes. There is no device fallback — a kernel backend on a CUDA
    tensor launches the kernel or raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend.startswith("cuda") and not kernel_takes(cfg):
        return backend.replace("cuda", "matmul")
    return backend


def arithmetic_backend(cfg: MelConfig, backend: str, device) -> str:
    """The name of the arithmetic that runs for (cfg, backend) on
    ``device``, for cache keys: ``resolved_backend``, and for a kernel backend
    off the card, where ``mel_power`` runs its plain version (plain f32 or
    plain bf16, not the card's tensor-core sums), ``<backend>-cpuplain``."""
    name = resolved_backend(cfg, backend)
    if name.startswith("cuda") and torch.device(device).type != "cuda":
        return f"{name}-cpuplain"
    return name


def log_mel_batch(
    y: torch.Tensor,
    cfg: MelConfig,
    *,
    parity: bool = True,
    backend: str = "cuda",
    rms_scale: torch.Tensor | None = None,
    pre_padded: bool = False,
) -> torch.Tensor:
    """[B, num_samples] f32 waveforms -> [B, target_frames, n_mels] log-mels.

    ``rms_scale`` [B] (from :func:`rms_scale_batch`) fuses RMS normalization
    into the mel op. ``pre_padded``: rows are in ``phase_padded_layout`` for
    the frames computed; on the matmul backends the valid region is sliced
    back out (parity mode only: the fast frontend's layout drops the tail).
    """
    if y.ndim == 1:
        y = y[None]
    if parity:
        num_frames, first = cfg.total_frames, 0
    else:
        total = cfg.total_frames
        num_frames = min(cfg.target_frames, total)
        first = max(0, (total - cfg.target_frames) // 2)
    backend = resolved_backend(cfg, backend)
    if backend.startswith("cuda"):
        S = mel_power(y, cfg, num_frames=num_frames, first_frame=first, rms_scale=rms_scale,
                      pre_padded=pre_padded, exact=backend == "cuda")
    else:
        if pre_padded:
            if first:
                raise ValueError(
                    "pre_padded input requires a mel kernel in fast-frontend "
                    "mode (the padded layout drops the tail)"
                )
            _, pad_l = phase_padded_layout(cfg, num_frames)
            y = y[:, pad_l : pad_l + cfg.num_samples]
        y = apply_rms_scale(y, rms_scale)
        bf16 = backend == "matmul-bf16"
        P = stft_power(y, n_fft=cfg.n_fft, hop_length=cfg.hop_length, num_frames=num_frames,
                       first_frame=first, bf16=bf16)
        fb = torch.from_numpy(mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)).to(y.device)
        if bf16:
            P, fb = round_bf16(P), round_bf16(fb)
        with exact_f32():
            S = P @ fb
    # stats-first epilogue: dB ref and mean/std over the computed [T, M] plane
    # (the full clip in parity mode), normalize only the cropped frames (the
    # affine map commutes with the crop)
    S_db = power_to_db(S, amin=cfg.amin, top_db=cfg.top_db)
    mean, std = mean_std(S_db)
    if S_db.shape[-2] >= cfg.target_frames:
        return (crop_or_pad_time(S_db, cfg.target_frames) - mean) / (std + STANDARDIZE_EPS)
    # short clips pad after normalizing, so the pad stays exact zeros
    return crop_or_pad_time((S_db - mean) / (std + STANDARDIZE_EPS), cfg.target_frames)


def mel_to_encoder_input(mel_tm: torch.Tensor) -> torch.Tensor:
    """[B, T, M] -> [B, T, M, 1] NHWC encoder input (the reference package's
    layout at the public boundary)."""
    return mel_tm[..., None]
