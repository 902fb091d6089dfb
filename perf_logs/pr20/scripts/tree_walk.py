"""Three walks of a folder-benchmark-sized tree where the benchmark writes its
inputs (``tempfile``'s directory, the run's ``TMPDIR``): the rglob + ``is_file``
scan the folder benchmark used before, a bare ``os.scandir`` listing of the
same directories, and ``pipeline.dataset.scan_species_tree``; plus the same
walk with its type checks on a pool of 8 threads, and the ``d_type`` that
``readdir`` hands out there.

    python perf_logs/pr20/scripts/tree_walk.py [--species 4] [--per-species 512] [--repeats 5]

from the root of a checkout. Prints one JSON line: the mount under the
directory (``/proc/self/mountinfo``), the ``d_type`` counts of its listings,
and each walk's times in ms."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

from anuraxla_torch.pipeline.dataset import scan_species_tree  # noqa: E402

FILE_BYTES = 44 + 48000 * 5 * 2  # one 5 s 48 kHz PCM16 mono WAV, as the folder cell writes


def rglob_scan(root: Path):
    """The folder benchmark's scan before the walk: rglob, then a stat a file."""
    root = Path(root)
    names = [d.name for d in sorted(d for d in root.iterdir() if d.is_dir() and not d.name.startswith("."))]
    return {n: sorted(p for p in (root / n).rglob("*") if p.is_file() and p.suffix in (".wav", ".WAV")) for n in names}


def bare_listing(root: Path):
    """Every directory listed, no type asked and no path built."""
    todo, n = [str(root)], 0
    while todo:
        with os.scandir(todo.pop()) as it:
            for e in it:
                n += 1
                if e.name.startswith("s") and "." not in e.name:  # the species directories by name alone
                    todo.append(e.path)
    return n


def pooled_walk(root: Path, pool: ThreadPoolExecutor):
    """The walk with every entry's type check on the pool (the fallback where
    the listing carries no type)."""
    root = Path(root)
    with os.scandir(root) as it:
        top = [e for e in it if not e.name.startswith(".")]
    names = sorted(e.name for e, d in zip(top, pool.map(lambda e: e.is_dir(), top)) if d)
    out = {}
    for name in names:
        wavs, todo = [], [root / name]
        while todo:
            d = todo.pop()
            with os.scandir(d) as it:
                entries = list(it)
            kinds = pool.map(lambda e: (e.is_dir(follow_symlinks=False),
                                        e.name[-4:] in (".wav", ".WAV") and len(e.name) > 4 and e.is_file()), entries)
            for e, (is_dir, is_wav) in zip(entries, kinds):
                if is_dir:
                    todo.append(d / e.name)
                elif is_wav:
                    wavs.append(d / e.name)
        out[name] = sorted(wavs)
    return out


class Dirent(ctypes.Structure):
    _fields_ = [("d_ino", ctypes.c_uint64), ("d_off", ctypes.c_int64), ("d_reclen", ctypes.c_ushort),
                ("d_type", ctypes.c_ubyte), ("d_name", ctypes.c_char * 256)]


def d_types(dirs):
    libc = ctypes.CDLL(None, use_errno=True)
    libc.opendir.restype, libc.opendir.argtypes = ctypes.c_void_p, [ctypes.c_char_p]
    libc.readdir.restype, libc.readdir.argtypes = ctypes.POINTER(Dirent), [ctypes.c_void_p]
    libc.closedir.argtypes = [ctypes.c_void_p]
    names = {0: "DT_UNKNOWN", 4: "DT_DIR", 8: "DT_REG", 10: "DT_LNK"}
    counts = {}
    for d in dirs:
        h = libc.opendir(str(d).encode())
        while True:
            ent = libc.readdir(h)
            if not ent:
                break
            if ent.contents.d_name in (b".", b".."):
                continue
            k = names.get(ent.contents.d_type, str(ent.contents.d_type))
            counts[k] = counts.get(k, 0) + 1
        libc.closedir(h)
    return counts


def mount_of(path: str):
    best = None
    with open("/proc/self/mountinfo") as f:
        for line in f:
            left, _, right = line.partition(" - ")
            point = left.split()[4]
            if (path == point or path.startswith(point.rstrip("/") + "/")) and (best is None or len(point) > len(best[0])):
                best = (point, right.split()[0], right.split()[1], left.split()[5], right.split()[2] if len(right.split()) > 2 else "")
    return dict(zip(("point", "fstype", "source", "mount_opts", "super_opts"), best)) if best else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--species", type=int, default=4)
    p.add_argument("--per-species", type=int, default=512)
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)

    work = Path(tempfile.mkdtemp(prefix="tree-walk-"))
    try:
        root = work / "tree"
        blob = b"\0" * FILE_BYTES
        t = time.perf_counter()
        for k in range(args.species):
            (root / f"sp{k}").mkdir(parents=True)
            for i in range(args.per_species):
                (root / f"sp{k}" / f"c{i:05d}.wav").write_bytes(blob)
        os.sync()
        write_s = time.perf_counter() - t
        ref = rglob_scan(root)
        counts = {}
        got = scan_species_tree(root, counts=counts)
        pool = ThreadPoolExecutor(8)
        same = {"walk": got == ref, "pooled": pooled_walk(root, pool) == ref,
                "strs": [str(x) for v in got.values() for x in v] == [str(x) for v in ref.values() for x in v]}
        walks = {"rglob_stat": lambda: rglob_scan(root), "bare_listing": lambda: bare_listing(root),
                 "walk": lambda: scan_species_tree(root), "pooled_walk": lambda: pooled_walk(root, pool)}
        ms = {k: [] for k in walks}
        for _ in range(args.repeats):
            for k, f in walks.items():
                t = time.perf_counter()
                f()
                ms[k].append(round((time.perf_counter() - t) * 1e3, 3))
        pool.shutdown()
        print(json.dumps({"tmpdir": str(work), "mount": mount_of(str(work)), "files": sum(map(len, ref.values())),
                          "write_s": round(write_s, 3), "d_type": d_types([root] + [root / n for n in ref]),
                          "walk_counts": counts, "same": same, "ms": ms,
                          "median_ms": {k: statistics.median(v) for k, v in ms.items()}}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
