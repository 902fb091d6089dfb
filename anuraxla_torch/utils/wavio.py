"""WAV I/O without librosa/soundfile — a copy of ``anuraxla/utils/wavio.py``
(``_parse_wav_bytes``, ``resample``, ``read_wav``, ``write_wav``,
``WavStream``, ``crop_or_pad_samples``).

- a pure-NumPy RIFF/WAVE parser (PCM 8/16/24/32-bit and IEEE float32/64),
- mono mixdown (mean over channels, matching librosa.to_mono),
- polyphase resampling via scipy when the file rate differs from the target,
- a PCM16 writer (what the reference's normalized datasets are stored as),
- ``WavStream``, a memmap reader that serves windows of long recordings.
"""
from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PCM_DTYPES = {8: np.uint8, 16: np.dtype("<i2"), 32: np.dtype("<i4")}

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _parse_wav_bytes(buf: bytes) -> Tuple[np.ndarray, int]:
    """Decode a RIFF/WAVE byte buffer -> (float32 samples [n, channels], sr)."""
    if len(buf) < 12 or buf[0:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    pos = 12
    fmt = None
    data: Optional[bytes] = None
    while pos + 8 <= len(buf):
        cid = buf[pos : pos + 4]
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        body = buf[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            audio_format = fmt[0]
            if audio_format == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                # SubFormat GUID: first 2 bytes carry the real format tag.
                (audio_format,) = struct.unpack_from("<H", body, 24)
            fmt = (audio_format,) + fmt[1:]
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or data is None:
        raise ValueError("WAV missing fmt/data chunk")

    audio_format, channels, sr, _byte_rate, _block_align, bits = fmt
    if channels <= 0:
        raise ValueError("WAV has zero channels")
    # mirror the native decoder: a zero rate divides by zero in the
    # resampler's gcd reduction, an absurd one demands an unbounded filter
    # design — corrupt header either way
    if sr <= 0 or sr > 2_000_000:
        raise ValueError("implausible WAV sample rate")

    if audio_format == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            x = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(data, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float bit depth: {bits}")
    elif audio_format == WAVE_FORMAT_PCM:
        if bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8)
            raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
            # sign-extend little-endian 24-bit into int32
            as_i32 = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            as_i32 = np.where(as_i32 >= 1 << 23, as_i32 - (1 << 24), as_i32)
            x = (as_i32 / float(1 << 23)).astype(np.float32)
        elif bits in _PCM_DTYPES:
            raw = np.frombuffer(data, dtype=_PCM_DTYPES[bits])
            if bits == 8:  # unsigned
                x = ((raw.astype(np.float32) - 128.0) / 128.0).astype(np.float32)
            else:
                x = (raw.astype(np.float32) / float(1 << (bits - 1))).astype(np.float32)
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    else:
        raise ValueError(f"unsupported WAV format tag: {audio_format:#x}")

    n = (x.shape[0] // channels) * channels
    return x[:n].reshape(-1, channels), int(sr)


def resample(y: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (scipy kaiser window). librosa.load uses
    soxr/resampy; exact resampler parity is not required by the math anywhere
    downstream (datasets ship at 48 kHz), but quality should be comparable."""
    if sr_in == sr_out:
        return y
    from scipy.signal import resample_poly

    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    # same bound as the native decoder: resample_poly designs a
    # 20*max(up,down)+1-tap filter, so a co-prime bogus header rate would
    # demand unbounded design work — fail the file, never hang the process
    if max(up, down) > 1 << 17:
        raise ValueError("unsupported resample ratio (filter too long)")
    return resample_poly(y, up, down).astype(np.float32)


def read_wav(
    path: str | Path,
    sr: Optional[int] = None,
    mono: bool = True,
) -> Tuple[np.ndarray, int]:
    """Load a WAV as float32 in [-1, 1], mirroring ``librosa.load`` semantics:
    mono mixdown by channel mean, optional resample to ``sr``.

    Returns (samples, sample_rate). ``samples`` is 1-D when mono else [n, C].
    """
    buf = Path(path).read_bytes()
    x, file_sr = _parse_wav_bytes(buf)
    if mono:
        y = x.mean(axis=1).astype(np.float32) if x.shape[1] > 1 else x[:, 0]
    else:
        y = x
    if sr is not None and sr != file_sr:
        y = resample(y, file_sr, sr)
        file_sr = sr
    return np.ascontiguousarray(y, dtype=np.float32), file_sr


def write_wav(path: str | Path, y: np.ndarray, sr: int, *, subtype: str = "PCM_16") -> None:
    """Write mono/float WAV. ``PCM_16`` matches soundfile's default used by
    the reference normalizer; ``FLOAT`` keeps full precision for tests."""
    y = np.asarray(y)
    if y.ndim == 1:
        y = y[:, None]
    channels = y.shape[1]

    if subtype == "PCM_16":
        # libsndfile convention: scale by 32768, clip to int16 range; the
        # reader divides by 32768, so roundtrip error is ≤ 0.5 LSB.
        fmt_tag, bits = WAVE_FORMAT_PCM, 16
        q = np.clip(np.round(y * 32768.0), -32768, 32767)
        payload = q.astype("<i2").tobytes()
    elif subtype == "FLOAT":
        fmt_tag, bits = WAVE_FORMAT_IEEE_FLOAT, 32
        payload = y.astype("<f4").tobytes()
    else:
        raise ValueError(f"unsupported subtype: {subtype}")

    block_align = channels * bits // 8
    byte_rate = sr * block_align
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, sr, byte_rate, block_align, bits)
    out = b"".join(
        [
            b"RIFF",
            struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(payload)),
            b"WAVE",
            b"fmt ",
            struct.pack("<I", len(fmt)),
            fmt,
            b"data",
            struct.pack("<I", len(payload)),
            payload,
        ]
    )
    Path(path).write_bytes(out)


class WavStream:
    """Random-access streaming reader for long WAVs (multi-hour soundscapes).

    Parses the header once, then serves float32 mono segments on demand via a
    numpy memmap — a 2 h 48 kHz recording is windowed without ever holding
    more than the requested segment in memory. Supports the memmap-friendly
    encodings (PCM 16/32, float32/64); for exotic depths fall back to
    ``read_wav``.
    """

    _MMAP_DTYPES = {
        (WAVE_FORMAT_PCM, 16): ("<i2", 32768.0),
        (WAVE_FORMAT_PCM, 32): ("<i4", 2147483648.0),
        (WAVE_FORMAT_IEEE_FLOAT, 32): ("<f4", 1.0),
        (WAVE_FORMAT_IEEE_FLOAT, 64): ("<f8", 1.0),
    }

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            head = f.read(1 << 16)
        if len(head) < 12 or head[0:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        pos = 12
        fmt = None
        data_off = data_len = None
        file_size = self.path.stat().st_size
        while pos + 8 <= len(head):
            cid = head[pos : pos + 4]
            (size,) = struct.unpack_from("<I", head, pos + 4)
            if cid == b"fmt ":
                f_ = struct.unpack_from("<HHIIHH", head, pos + 8)
                audio_format = f_[0]
                if audio_format == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                    (audio_format,) = struct.unpack_from("<H", head, pos + 32)
                fmt = (audio_format,) + f_[1:]
            elif cid == b"data":
                data_off = pos + 8
                data_len = min(size, file_size - data_off)
            pos += 8 + size + (size & 1)
        if fmt is None or data_off is None:
            raise ValueError("WAV missing fmt/data chunk (or data beyond 64KB header scan)")

        self.format, self.channels, self.sr, _, _, self.bits = fmt
        key = (self.format, self.bits)
        if key not in self._MMAP_DTYPES:
            raise ValueError(f"WavStream unsupported encoding {key}; use read_wav")
        dt, self._scale = self._MMAP_DTYPES[key]
        itemsize = np.dtype(dt).itemsize
        n_values = data_len // itemsize
        self.num_frames = n_values // self.channels
        self._mm = np.memmap(self.path, dtype=dt, mode="r", offset=data_off,
                             shape=(self.num_frames, self.channels))

    @property
    def duration_seconds(self) -> float:
        return self.num_frames / self.sr

    def read(self, start: int, n: int) -> np.ndarray:
        """Mono float32 segment [n] at frame offset ``start`` (zero-padded
        past EOF)."""
        start = max(0, start)
        stop = min(start + n, self.num_frames)
        seg = np.asarray(self._mm[start:stop], dtype=np.float32) / self._scale
        y = seg.mean(axis=1) if self.channels > 1 else seg[:, 0]
        if y.shape[0] < n:
            y = np.pad(y, (0, n - y.shape[0]))
        return y.astype(np.float32)

    @property
    def is_pcm16_mono(self) -> bool:
        return self.format == WAVE_FORMAT_PCM and self.bits == 16 and self.channels == 1

    def read_i16(self, start: int, n: int) -> np.ndarray:
        """Raw int16 segment [n] (PCM16 mono only; zero-padded past EOF) —
        a pure memmap copy, no float conversion. ``read()`` for these files
        is exactly ``read_i16().astype(float32) / 32768``, and the
        transfer_int16 link re-quantization of that float is the identity,
        so shipping this buffer directly is bitwise-equal to the float
        round trip at zero host CPU cost."""
        if not self.is_pcm16_mono:
            raise ValueError("read_i16 requires a PCM16 mono stream")
        start = max(0, start)
        stop = min(start + n, self.num_frames)
        y = np.asarray(self._mm[start:stop, 0])
        if y.shape[0] < n:
            y = np.pad(y, (0, n - y.shape[0]))
        return y


def crop_or_pad_samples(y: np.ndarray, num_samples: int) -> np.ndarray:
    """Force a fixed duration: right-pad with zeros or truncate
    (``map_detector_core.py:212-217``)."""
    n = y.shape[0]
    if n < num_samples:
        return np.pad(y, (0, num_samples - n), mode="constant")
    return y[:num_samples]
