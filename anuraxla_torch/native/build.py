"""Build the native WAV batch decoder (``wavio.cpp``, a copy of the JAX
package's) into a shared library with ``g++`` — no external dependencies.

Called at first use by ``wavloader`` (or by hand:
``python -m anuraxla_torch.native.build``), never at import. The library goes
to ``anuraxla_torch/_build/libavldwav-<hash>.so``, keyed by the content of the
source and the compiler flags, and is written through a temporary file and a
rename, so concurrent builds never see half a library. The flags name no
host ISA (no ``-march=native``): a library built on one machine loads on any
x86-64 host the checkout is copied to.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "wavio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall", "-Wextra"]


def lib_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libavldwav-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """The library's path, building it if it is missing. Raises if ``g++``
    fails or is absent."""
    lib = lib_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed:\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


if __name__ == "__main__":
    print(build())
