"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (``anuraxla_torch/_build/lib<name>-<hash>.so``,
keyed by the content of the source and of the ``*.cuh`` headers beside it)
and loaded with ``ctypes`` at first use; ``build`` compiles several libraries
at once, one ``nvcc`` each, as many at a time as the host has cores.
``VARIANTS`` names libraries built from another
library's source with extra ``-D`` flags: the ablated instantiations of the
Cooley–Tukey kernel, one small library a mask, kept out of the serving library
and built only when a profiling run asks for that mask. Only
the repository's sources are read. No PyTorch headers are included, so a
build takes seconds. ``ptxas``'s report (registers, spills) is kept beside the
library as ``lib<name>-<hash>.log``. A missing ``nvcc`` or a failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# library -> (source it is built from, extra nvcc flags)
VARIANTS = {f"mel_power_ct_ablate{mask}": ("mel_power_ct", (f"-DMEL_POWER_CT_ABLATE={mask}",))
            for mask in range(1, 64)}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")


def source_of(name: str) -> str:
    """The source (and the prefix of the C symbols) a library is built from."""
    return VARIANTS.get(name, (name,))[0]


def _flags(name: str) -> list[str]:
    return [*NVCC_FLAGS, *VARIANTS.get(name, (name, ()))[1]]


def lib_path(name: str) -> Path:
    """The library's path, keyed by the content of its source, of the headers
    beside it and of the compiler flags."""
    h = hashlib.sha1((CSRC / f"{source_of(name)}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def sources() -> list[str]:
    """The names of every kernel source under ``csrc/`` (each is a library;
    ``VARIANTS`` names the others)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Iterable[str]) -> None:
    """Build the libraries of ``names`` that are missing: one ``nvcc`` for
    each library, as many at once as the host has cores. Raises if any
    build fails."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [name for name in dict.fromkeys(names) if not lib_path(name).exists()]
    running, failed = [], []

    def finish(name, out, tmp, proc):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
            return
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a reader never sees half a file

    for name in todo:
        if len(running) >= (os.cpu_count() or 1):
            finish(*running.pop(0))
        out = lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{source_of(name)}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc))
    for job in running:
        finish(*job)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it if it is missing."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
    return lib
