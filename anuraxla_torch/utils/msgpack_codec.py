"""A small msgpack reader and writer for flax's serialization format, so
that encoder artifacts load and save on a host without ``flax`` or
``msgpack`` (the card's machine has neither).

Covers what ``flax.serialization.to_bytes`` writes for a param tree: maps
with str keys, arrays (msgpack lists), str, bin, ints, floats, bool and nil,
and ext type 1 — an ndarray packed as the msgpack array ``(shape, dtype
name, C-order bytes)`` — and ext type 3, a numpy scalar packed the same way.
Arrays are read as numpy arrays (read-only views of the input bytes).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


def _pack_len(out: bytearray, n: int, small_tag: int | None, small_max: int, tags: tuple) -> None:
    if small_tag is not None and n <= small_max:
        out.append(small_tag | n)
        return
    for tag, fmt in zip(tags, (">B", ">H", ">I")):
        if tag is not None and n < 1 << (8 * struct.calcsize(fmt)):
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int) and not isinstance(obj, np.integer):
        if 0 <= obj < 128 or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            for tag, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
                if obj < 1 << (8 * struct.calcsize(fmt)):
                    out.append(tag)
                    out += struct.pack(fmt, obj)
                    return
            raise ValueError(f"msgpack: int {obj} too large")
        else:
            for tag, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
                if obj >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                    out.append(tag)
                    out += struct.pack(fmt, obj)
                    return
            raise ValueError(f"msgpack: int {obj} too small")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: map keys must be str, got {type(k).__name__}")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject or arr.dtype.fields is not None:
            raise ValueError("msgpack: object and structured dtypes are not supported")
        data = packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        code = EXT_NDARRAY if isinstance(obj, np.ndarray) else EXT_NPSCALAR
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixed:
            out.append(fixed[len(data)])
        else:
            _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", code)
        out += data
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        chunk = self.buf[self.pos : self.pos + n]
        self.pos += n
        return chunk

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        t = self.num(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self.num(scalars[t])
        if t in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self.ext(1 << (t - 0xD4))
        if t not in sized:
            raise ValueError(f"msgpack: unsupported type byte 0x{t:02x}")
        n = self.num(sized[t])
        if t in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(n))
        if t in (0xD9, 0xDA, 0xDB):
            return self.str(n)
        if t in (0xDC, 0xDD):
            return [self.read() for _ in range(n)]
        if t in (0xDE, 0xDF):
            return self.map(n)
        return self.ext(n)

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.num(">b")
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported ext type {code}")
        shape, dtype_name, raw = unpackb(data)
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)
        return arr if code == EXT_NDARRAY else arr[()]


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing bytes")
    return obj
