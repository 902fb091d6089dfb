"""Plain WAV decode and RMS normalization (NumPy / PyTorch only).

Reads the PCM16 mono WAVs this benchmark writes: the ``data`` chunk as
little-endian int16, divided by 32768 in float32 (exact: a power of two).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch


def pcm16_data(path: Path) -> np.ndarray:
    """The samples of a PCM16 mono WAV as an int16 array (a view of its bytes)."""
    buf = Path(path).read_bytes()
    if buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    while pos + 8 <= len(buf):
        cid, size = buf[pos : pos + 4], struct.unpack_from("<I", buf, pos + 4)[0]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", buf, pos + 8)
        elif cid == b"data":
            if fmt is None or fmt[0] != 1 or fmt[1] != 1 or fmt[5] != 16:
                raise ValueError(f"{path}: not PCM16 mono ({fmt})")
            return np.frombuffer(buf, "<i2", count=min(size, len(buf) - pos - 8) // 2, offset=pos + 8)
        pos += 8 + size + (size & 1)
    raise ValueError(f"{path}: no data chunk")


def read_rows(paths, num_samples: int) -> np.ndarray:
    """[len(paths), num_samples] float32: each file cropped or zero-padded at its end."""
    out = np.zeros((len(paths), num_samples), np.float32)
    for i, p in enumerate(paths):
        x = pcm16_data(p)[:num_samples]
        out[i, : x.shape[0]] = x.astype(np.float32) / np.float32(32768.0)
    return out


def window(samples: np.ndarray, start: int, num_samples: int) -> np.ndarray:
    """``num_samples`` samples from ``start`` of an int16 recording as float32, zero past its end."""
    out = np.zeros(num_samples, np.float32)
    x = samples[start : start + num_samples]
    out[: x.shape[0]] = x.astype(np.float32) / np.float32(32768.0)
    return out


def rms_normalize(y: torch.Tensor, rms: dict) -> torch.Tensor:
    """Rows with RMS at or above the silence gate scaled to the target RMS and
    clipped to [-1, 1]; quieter rows unchanged."""
    r = torch.sqrt(torch.mean(y * y, dim=-1, keepdim=True))
    scaled = torch.clamp(y * (rms["target"] / (r + rms["eps"])), -1.0, 1.0)
    return torch.where(r >= rms["silence_gate"], scaled, y)
