"""Batched audio frontend: waveform rows -> model-ready log-mels — the port
of ``anuraxla/ops/frontend.py`` in its parity mode.

``parity=True``: the STFT covers the full clip; the dB reference (per-row
max), the 80 dB floor and the mean/std standardization are taken over all
frames before the center crop to ``target_frames`` — the reference order.

Backends (named apart from the JAX package's, so no cache key can mix the
two frameworks' latents):
- ``"cuda"``: the fused mel kernel (``ops.mel_kernel.mel_power``) — the
  Hopper kernel on a CUDA tensor, its plain PyTorch version on a CPU tensor;
- ``"matmul"``: dense STFT bases + filterbank matmul in full f32.
"""

from __future__ import annotations

import torch

from anuraxla_torch.constants import RMS_EPS, RMS_SILENCE_GATE, RMS_TARGET, MelConfig
from anuraxla_torch.ops.mel import STANDARDIZE_EPS, crop_or_pad_time, mean_std, mel_filterbank, power_to_db
from anuraxla_torch.ops.mel_kernel import apply_rms_scale, kernel_takes, mel_power, phase_padded_layout
from anuraxla_torch.ops.stft import stft_power
from anuraxla_torch.utils.precision import exact_f32

BACKENDS = ("cuda", "matmul")


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
    carries over from the reference: ``"cuda"`` names ``"matmul"`` for a
    config the kernel does not take. There is no device fallback — a
    ``"cuda"`` backend on a CUDA tensor launches the kernel or raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "cuda" and not kernel_takes(cfg):
        return "matmul"
    return backend


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
    into the mel op. ``pre_padded``: rows are in ``phase_padded_layout``;
    on the matmul backend the valid region is sliced back out.
    """
    if not parity:
        raise NotImplementedError("the fast frontend (parity=False) is not ported yet")
    if y.ndim == 1:
        y = y[None]
    num_frames = cfg.total_frames
    backend = resolved_backend(cfg, backend)
    if backend == "cuda":
        S = mel_power(y, cfg, num_frames=num_frames, rms_scale=rms_scale, pre_padded=pre_padded)
    else:
        if pre_padded:
            _, pad_l = phase_padded_layout(cfg, num_frames)
            y = y[:, pad_l : pad_l + cfg.num_samples]
        y = apply_rms_scale(y, rms_scale)
        P = stft_power(y, n_fft=cfg.n_fft, hop_length=cfg.hop_length, num_frames=num_frames)
        fb = torch.from_numpy(mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)).to(y.device)
        with exact_f32():
            S = P @ fb
    # stats-first epilogue: dB ref and mean/std over the full [T, M] plane,
    # normalize only the cropped frames (the affine map commutes with the crop)
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
