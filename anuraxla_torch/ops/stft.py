"""Batched STFT power spectrum — the port of ``anuraxla/ops/stft.py``.

``hann_window`` and ``_dft_bases`` are numpy copies (pinned bitwise to the
reference by a test). ``stft_power`` is the dense ``"matmul"`` backend:
frames [B·T, n_fft] times the windowed cos/-sin bases [n_fft, n_freq], in
full f32 or (``bf16=True``, the ``"matmul-bf16"`` backend) with both operands
rounded to bf16. It is the dense oracle the mel kernels are tested against,
and the path for configs no kernel takes (``frontend.resolved_backend``).

librosa parity: the Hann window is periodic (fftbins=True); frames are
centered (n_fft//2 zeros on both sides). ``first_frame`` lets the crop-first
frontend compute only the frames that survive the center crop.
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


def frames_of_padded(
    y_padded: torch.Tensor, *, n_fft: int, hop_length: int, num_frames: int, first_frame: int = 0
) -> torch.Tensor:
    """[B, L] rows whose frame t starts at sample t·hop -> [B, num_frames,
    n_fft] frames first_frame.., as a strided view; frames past the row's end
    read zeros."""
    need = (first_frame + num_frames - 1) * hop_length + n_fft
    if need > y_padded.shape[1]:
        y_padded = F.pad(y_padded, (0, need - y_padded.shape[1]))
    return y_padded.unfold(-1, n_fft, hop_length)[:, first_frame : first_frame + num_frames]


def frame_signal(
    y: torch.Tensor, *, n_fft: int, hop_length: int, num_frames: int, first_frame: int = 0
) -> torch.Tensor:
    """[B, L] -> [B, num_frames, n_fft] centered frames first_frame.. (librosa
    center=True: n_fft//2 zeros on each side; frames past the end read
    zeros)."""
    pad = n_fft // 2
    return frames_of_padded(F.pad(y, (pad, pad)), n_fft=n_fft, hop_length=hop_length,
                            num_frames=num_frames, first_frame=first_frame)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def stft_power(
    y: torch.Tensor, *, n_fft: int, hop_length: int, num_frames: int,
    first_frame: int = 0, bf16: bool = False,
) -> torch.Tensor:
    """Centered |STFT|² of [B, L] f32 signals -> [B, num_frames,
    n_fft//2 + 1] (time-major), dense windowed-DFT bases in full f32.

    ``bf16=True`` rounds the frames and the bases to bf16 and accumulates in
    f32: what the reference's ``Precision.DEFAULT`` does on a TPU. JAX on a
    CPU computes DEFAULT in f32, so a CPU comparison with the reference holds
    this mode only to the bf16 tolerance (1e-2 of the spectrum's max)."""
    frames = frame_signal(y, n_fft=n_fft, hop_length=hop_length, num_frames=num_frames,
                          first_frame=first_frame)
    cos_b, sin_b = (torch.from_numpy(b).to(y.device) for b in _dft_bases(n_fft))
    if bf16:
        frames, cos_b, sin_b = round_bf16(frames), round_bf16(cos_b), round_bf16(sin_b)
    with exact_f32():
        re = torch.matmul(frames, cos_b)
        im = torch.matmul(frames, sin_b)
    return re * re + im * im
