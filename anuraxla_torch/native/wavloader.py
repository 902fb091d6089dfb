"""ctypes binding for the native WAV batch decoder (``wavio.cpp``) — the port
of ``anuraxla/native/wavloader.py``.

The hot path of ``pipeline.dataset.load_wav_batch``; the pure-Python reader
stays the fallback (a host without ``g++``) and the oracle the tests hold it
to (``use_native=False`` there). Unlike the reference, ``decode_into`` writes
into a buffer the caller owns — the session's pinned host slot — so decoded
rows need no further host copy.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

ABI_VERSION = 2
_ERR_STRIDE = 160
_lib = None
_load_failed = False
_lock = threading.Lock()


def _get_lib():
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            from anuraxla_torch.native.build import build

            lib = ctypes.CDLL(str(build()))
            lib.avld_load_wav_batch_strided.restype = ctypes.c_int
            lib.avld_load_wav_batch_strided.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.avld_abi_version.restype = ctypes.c_int
            lib.avld_abi_version.argtypes = []
            if lib.avld_abi_version() != ABI_VERSION:
                raise RuntimeError("native ABI mismatch")
            _lib = lib
        except (OSError, RuntimeError):
            _load_failed = True
        return _lib


def available() -> bool:
    return _get_lib() is not None


def decode_into(
    paths: Sequence[Path], out: np.ndarray, *, sr: int, num_samples: int, col_offset: int = 0,
    num_threads: int = 16,
) -> tuple[np.ndarray, List[Optional[str]]]:
    """Decode ``paths`` into rows ``0 .. len(paths) − 1`` of ``out`` (float32,
    C-contiguous, [>= len(paths), row_len]), each file's samples at
    ``out[i, col_offset : col_offset + num_samples]`` (cropped or zero-padded;
    a failed row's window is zeroed). Columns outside the window are not
    touched. -> (ok [n] bool, errors [n])."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(
            "native WAV loader unavailable (the g++ build failed): use the "
            "pure-Python reader (pipeline.dataset does this automatically)"
        )
    n = len(paths)
    if out.dtype != np.float32 or out.ndim != 2 or not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("out must be a writeable C-contiguous float32 [rows, row_len] array")
    if out.shape[0] < n or col_offset < 0 or col_offset + num_samples > out.shape[1]:
        raise ValueError(f"out {out.shape} cannot hold {n} rows of {num_samples} samples at column {col_offset}")
    ok = np.zeros(n, np.uint8)
    errbuf = ctypes.create_string_buffer(max(n, 1) * _ERR_STRIDE)
    c_paths = (ctypes.c_char_p * max(n, 1))(*[str(p).encode() for p in paths])
    if n:
        lib.avld_load_wav_batch_strided(
            c_paths, n, sr, num_samples,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.shape[1], col_offset,
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), errbuf, _ERR_STRIDE, num_threads,
        )
    errors: List[Optional[str]] = []
    for i in range(n):
        if ok[i]:
            errors.append(None)
        else:
            raw = errbuf.raw[i * _ERR_STRIDE : (i + 1) * _ERR_STRIDE].split(b"\0", 1)[0]
            errors.append(raw.decode(errors="replace") or "decode failed")
    return ok.astype(bool), errors
