"""Plain log-mel frontend (librosa's semantics, written out in PyTorch):
centred |STFT|² with a periodic Hann window and zero padding, a Slaney mel
filterbank, ``power_to_db(ref=max, amin, top_db)`` over the whole clip, the
clip's mean and population std, then the centre crop to ``target_frames``."""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_hz / f_sp + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3.0, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


def filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalised triangular filters, [n_fft // 2 + 1, n_mels] float32."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    edges = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    w = np.zeros((n_mels, freqs.shape[0]))
    for m in range(n_mels):
        lo, c, hi = edges[m], edges[m + 1], edges[m + 2]
        rising = (freqs - lo) / (c - lo)
        falling = (hi - freqs) / (hi - c)
        w[m] = np.maximum(0.0, np.minimum(rising, falling)) * (2.0 / (hi - lo))
    return np.ascontiguousarray(w.T.astype(np.float32))


def log_mel(y: torch.Tensor, mel: dict, std_eps: float,
            rounding: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """[B, num_samples] float32 -> [B, target_frames, n_mels]. ``rounding``
    (a control) rounds the power spectrum and the filterbank before their product."""
    n_fft, hop = mel["n_fft"], mel["hop_length"]
    k = torch.arange(n_fft, dtype=torch.float64, device=y.device)
    win = (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n_fft)).float()
    X = torch.stft(y, n_fft, hop_length=hop, window=win, center=True, pad_mode="constant", return_complex=True)
    P = (X.real * X.real + X.imag * X.imag).transpose(1, 2)  # [B, T, n_freq]
    fb = torch.from_numpy(filterbank(mel["sr"], n_fft, mel["n_mels"], mel["fmin"], mel["fmax"])).to(y.device)
    if rounding is not None:
        P, fb = rounding(P), rounding(fb)
    S = P @ fb
    log10 = math.log(10.0)
    db = 10.0 * torch.log(torch.clamp(S, min=mel["amin"])) / log10
    ref = 10.0 * torch.log(torch.clamp(S.amax(dim=(1, 2), keepdim=True), min=mel["amin"])) / log10
    db = torch.clamp(db - ref, min=-mel["top_db"])
    mean = db.mean(dim=(1, 2), keepdim=True)
    std = db.std(dim=(1, 2), keepdim=True, correction=0)
    T, t = db.shape[1], mel["target_frames"]
    if T < t:
        raise ValueError(f"{T} frames cannot be cropped to {t}")
    s0 = (T - t) // 2
    return (db[:, s0 : s0 + t] - mean) / (std + std_eps)
