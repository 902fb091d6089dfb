"""Cold-cache IO of the port's native WAV decoder — the port of
``scripts/probe_cold_io.py``. Decode bounds every host path of the port
(``PERF.md`` §5), so this measures the port's own bottleneck when the files
are not in the page cache: the first pass over a freshly mounted recording
drive.

1. generate N small PCM16 WAVs (the benchmark chunk shape);
2. raw-IO legs over the set, the page cache EVICTED before each leg with
   fsync + posix_fadvise(DONTNEED) and the eviction checked with mincore
   (``*_resident_frac``: the first file's share still cached): buffered
   read(2), mmap touch (the decoder's access pattern), O_DIRECT aligned
   pread;
3. decoder legs: the native decoder (``native.wavloader.decode_into``, the
   route ``encode_paths`` takes) warm, then cold.

If O_DIRECT does not beat the cold buffered / mmap reads, an O_DIRECT read
path in ``native/wavio.cpp`` buys nothing on this class of storage (it turns
readahead off, which sequential ~0.5 MB files want).

    python -m anuraxla_torch.probes.cold_io [--files 256] [--seconds 5] [--threads 4] [--root DIR]

Prints progress lines, then one JSON line of rates (MB/s, files/s). These
are host numbers: on the card's machine the first line names the card the
host carries, the IO touches none of it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import mmap
import os
import tempfile
import time
from pathlib import Path

import numpy as np

PAGE = 4096


def evict(path: Path) -> None:
    """Drop the file's pages from the page cache. Dirty pages stay whatever
    DONTNEED says, so the file is written back first: the reference evicted
    files it had just written, and its first leg read them warm."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def resident_fraction(path: Path) -> float:
    """Fraction of the file's pages in the page cache (mincore)."""
    # raw mmap/mincore/munmap through libc: the mmap module can't hand
    # ctypes a stable address without exporting a buffer it then refuses
    # to close over
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_long]
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    fd = os.open(path, os.O_RDONLY)
    try:
        size = os.fstat(fd).st_size
        addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED, fd, 0)
        if addr in (None, ctypes.c_void_p(-1).value):
            return float("nan")
        try:
            npages = (size + PAGE - 1) // PAGE
            vec = (ctypes.c_ubyte * npages)()
            if libc.mincore(addr, size, vec) != 0:
                return float("nan")
            return sum(v & 1 for v in vec) / npages
        finally:
            libc.munmap(addr, size)
    finally:
        os.close(fd)


def leg_buffered(paths) -> float:
    t0 = time.perf_counter()
    total = 0
    for p in paths:
        with open(p, "rb", buffering=0) as f:
            total += len(f.read())
    return total / (time.perf_counter() - t0)


def leg_mmap(paths) -> float:
    t0 = time.perf_counter()
    total = 0
    acc = 0
    for p in paths:
        fd = os.open(p, os.O_RDONLY)
        try:
            size = os.fstat(fd).st_size
            with mmap.mmap(fd, size, prot=mmap.PROT_READ) as m:
                # touch every page like the decoder's sequential sweep
                acc += sum(m[i] for i in range(0, size, PAGE))
        finally:
            os.close(fd)
        total += size
    dt = time.perf_counter() - t0
    if acc < 0:  # keep the sum alive
        print(acc)
    return total / dt


def leg_odirect(paths, block: int = 1 << 20) -> float | None:
    """Aligned O_DIRECT pread sweep; None if the file system refuses O_DIRECT."""
    raw = ctypes.create_string_buffer(block + PAGE)
    addr = (ctypes.addressof(raw) + PAGE - 1) & ~(PAGE - 1)
    libc = ctypes.CDLL(None, use_errno=True)
    libc.pread.restype = ctypes.c_ssize_t
    libc.pread.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_long]
    t0 = time.perf_counter()
    total = 0
    for p in paths:
        try:
            fd = os.open(p, os.O_RDONLY | os.O_DIRECT)
        except OSError:
            return None
        try:
            off = 0
            while True:
                n = libc.pread(fd, addr, block, off)
                if n < 0:  # EINVAL: the file system takes the flag but not the read
                    return None
                if n == 0:
                    break
                off += n
            total += off
        finally:
            os.close(fd)
    return total / (time.perf_counter() - t0)


def leg_native_decode(paths, sr: int, num_samples: int, threads: int) -> float:
    from anuraxla_torch.native.wavloader import decode_into

    t0 = time.perf_counter()
    out = np.zeros((len(paths), num_samples), np.float32)
    ok, errors = decode_into(paths, out, sr=sr, num_samples=num_samples, num_threads=threads)
    dt = time.perf_counter() - t0
    if not ok.all():
        raise RuntimeError(f"the native decoder failed on {int((~ok).sum())} files: {errors[int(np.argmin(ok))]}")
    return len(paths) / dt


def card_name() -> str | None:
    """The card the host carries (name, power limit), if there is one."""
    import torch

    if not torch.cuda.is_available():
        return None
    from anuraxla_torch.probes.common import card_line

    return card_line()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--files", type=int, default=256)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--root", type=str, default=None, help="default: cold_io_probe/ in the temp directory")
    args = ap.parse_args(argv)

    from anuraxla_torch.utils.wavio import write_wav

    root = Path(args.root) if args.root else Path(tempfile.gettempdir()) / "cold_io_probe"
    root.mkdir(parents=True, exist_ok=True)
    n_samp = int(args.seconds * args.sr)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(args.files):
        p = root / f"f{i:04d}.wav"
        if not p.exists():
            write_wav(p, (0.1 * rng.standard_normal(n_samp)).astype(np.float32), args.sr)
        paths.append(p)
    total_mb = sum(p.stat().st_size for p in paths) / 1e6
    print(f"# {len(paths)} files, {total_mb:.0f} MB total; card: {card_name()}", flush=True)

    def evict_all():
        for p in paths:
            evict(p)
        return resident_fraction(paths[0])

    results = {"files": len(paths), "total_mb": round(total_mb, 1)}

    # raw-IO legs (cold each time; eviction checked)
    for name, fn in (("buffered", leg_buffered), ("mmap", leg_mmap), ("odirect", leg_odirect)):
        rf = evict_all()
        rate = fn(paths)
        results[f"cold_{name}_mb_s"] = None if rate is None else rate / 1e6
        results[f"cold_{name}_resident_frac"] = rf
        print(f"cold {name}: {'unsupported' if rate is None else f'{rate / 1e6:.1f} MB/s'}", flush=True)
    # warm raw baseline for scale
    leg_buffered(paths)
    results["warm_buffered_mb_s"] = leg_buffered(paths) / 1e6

    # decoder legs
    warm = leg_native_decode(paths, args.sr, n_samp, args.threads)
    results["warm_decode_files_s"] = warm
    results["cold_decode_resident_frac"] = evict_all()
    cold = leg_native_decode(paths, args.sr, n_samp, args.threads)
    results["cold_decode_files_s"] = cold
    results["cold_warm_ratio"] = cold / warm
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
