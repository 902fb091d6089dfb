"""Batched STFT power spectrum — the port of ``anuraxla/ops/stft.py``.

``hann_window`` and ``_dft_bases`` are numpy copies (pinned bitwise to the
reference by a test). ``stft_power`` is the dense ``"matmul"`` backend:
frames [B·T, n_fft] times the windowed cos/-sin bases [n_fft, n_freq], in
full f32. It is the dense oracle the mel kernel is tested against, and the
path for configs the kernel does not take (``frontend.resolved_backend``).

librosa parity: the Hann window is periodic (fftbins=True); frames are
centered (n_fft//2 zeros on both sides). The fast frontend's frame offset
is not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from anuraxla_torch.utils.precision import exact_f32


def hann_window(n_fft: int) -> np.ndarray:
    """Periodic Hann window, identical to scipy.signal.get_window('hann', n, fftbins=True)."""
    k = np.arange(n_fft)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n_fft)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases (C, S) of shape [n_fft, n_freq] with
    C[n,k] = w[n]·cos(2πkn/N), S[n,k] = -w[n]·sin(2πkn/N), so that
    frames @ C + i·(frames @ S) == rfft(frames · w)."""
    n_freq = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freq, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    w = hann_window(n_fft).astype(np.float64)[:, None]
    return (
        (np.cos(ang) * w).astype(np.float32),
        (-np.sin(ang) * w).astype(np.float32),
    )


def frame_signal(y: torch.Tensor, *, n_fft: int, hop_length: int, num_frames: int) -> torch.Tensor:
    """[B, L] -> [B, num_frames, n_fft] centered frames (librosa
    center=True: n_fft//2 zeros on each side; frames past the end read
    zeros), as a strided view of the padded signal."""
    pad = n_fft // 2
    y = F.pad(y, (pad, pad))
    need = (num_frames - 1) * hop_length + n_fft
    if need > y.shape[1]:
        y = F.pad(y, (0, need - y.shape[1]))
    return y.unfold(-1, n_fft, hop_length)[:, :num_frames]


def stft_power(y: torch.Tensor, *, n_fft: int, hop_length: int, num_frames: int) -> torch.Tensor:
    """Centered |STFT|² of [B, L] f32 signals -> [B, num_frames,
    n_fft//2 + 1] (time-major), dense windowed-DFT bases in full f32."""
    frames = frame_signal(y, n_fft=n_fft, hop_length=hop_length, num_frames=num_frames)
    cos_b, sin_b = (torch.from_numpy(b).to(y.device) for b in _dft_bases(n_fft))
    with exact_f32():
        re = torch.matmul(frames, cos_b)
        im = torch.matmul(frames, sin_b)
    return re * re + im * im
