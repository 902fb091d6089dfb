"""Slaney mel filterbank and dB conversion — the port of
``anuraxla/ops/mel.py``.

``hz_to_mel`` / ``mel_to_hz`` / ``mel_filterbank`` are numpy copies (a test
pins them bitwise to the reference); ``power_to_db`` / ``standardize`` /
``crop_or_pad_time`` are torch ops over the trailing [T, M] axes.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0

# the reference's standardization epsilon (map_detector_core.py:232)
STANDARDIZE_EPS = 1e-8


def hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    mel = f / _F_SP
    return np.where(f >= _MIN_LOG_HZ, _MIN_LOG_MEL + np.log(f / _MIN_LOG_HZ) / _LOGSTEP, mel)


def mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f = m * _F_SP
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), f)


@functools.lru_cache(maxsize=16)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Triangular Slaney-normalized mel filterbank, shaped [n_freq, n_mels]
    (transposed vs librosa's [n_mels, n_freq])."""
    n_freq = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freq, dtype=np.float64)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]

    return np.ascontiguousarray(weights.T.astype(np.float32))  # [n_freq, n_mels]


def power_to_db(S: torch.Tensor, *, amin: float = 1e-10, top_db: float | None = 80.0) -> torch.Tensor:
    """``librosa.power_to_db(S, ref=np.max)`` over the trailing two axes.
    With ref = max(S), max(log_spec) is exactly 0, so the top_db floor is
    the constant -top_db (as in the reference)."""
    log10 = math.log(10.0)
    ref = S.amax(dim=(-2, -1), keepdim=True)
    log_spec = 10.0 * torch.log(torch.clamp(S, min=amin)) / log10
    log_spec = log_spec - 10.0 * torch.log(torch.clamp(ref, min=amin)) / log10
    if top_db is not None:
        log_spec = torch.clamp(log_spec, min=-top_db)
    return log_spec


def mean_std(S_db: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-example mean and population std (ddof=0) over [T, M]."""
    mean = S_db.mean(dim=(-2, -1), keepdim=True)
    std = S_db.std(dim=(-2, -1), keepdim=True, correction=0)
    return mean, std


def standardize(S_db: torch.Tensor, eps: float = STANDARDIZE_EPS) -> torch.Tensor:
    """(x - mean) / (std + eps) over the full [T, M] plane."""
    mean, std = mean_std(S_db)
    return (S_db - mean) / (std + eps)


def crop_or_pad_time(mel_tm: torch.Tensor, target_frames: int) -> torch.Tensor:
    """Center crop/pad along the time axis of a time-major [..., T, M] mel."""
    T = mel_tm.shape[-2]
    if T == target_frames:
        return mel_tm
    if T > target_frames:
        start = (T - target_frames) // 2
        return mel_tm[..., start : start + target_frames, :]
    pad_total = target_frames - T
    pad_left = pad_total // 2
    return F.pad(mel_tm, (0, 0, pad_left, pad_total - pad_left))
