"""Encoder families, found by name: a configuration's ``"family"`` (``conv-vae``
where it names none) is the module ``perfbench/families/<family>.py``, ``-``
read as ``_``. A family module gives:

- ``program_config(cfg)``: the port's encoder config object. The only
  function of the module that imports ``anuraxla_torch``, inside itself;
- ``make_params(cfg, seed, device)``: the seeded weights, a flat dict of
  named tensors that the port's session loads and the reference reads;
- ``encode(params, mels, cfg, rounding=None)``: the plain reference's ``mu``
  [n, D] in float32 with TF32 off from standardised log-mels [n, T, M];
  ``rounding`` (the control) rounds the operands of every product;
- ``latent_dim(cfg)``;
- ``encoder_macs(cfg)``: the encoder's least work a chunk, in MAC;
- ``cpu_cut(cfg)``: the configuration the CPU tests run, cut in depth and
  width where the published one would take too long there.

The math of a family's reference lives in ``perfbench/reference/``, which
imports nothing of the port.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
SEARCHED = (HERE,)  # where a family's file is looked for, in order (a test may put a directory of its own first)
DEFAULT = "conv-vae"
NAME = re.compile(r"[A-Za-z][A-Za-z0-9_-]{0,63}")


def name_of(cfg: dict) -> str:
    return cfg.get("family", DEFAULT)


def load(family: str) -> ModuleType:
    """The module of ``family``; SystemExit naming the family and the
    directories searched where there is none."""
    stem = family.replace("-", "_") if isinstance(family, str) and NAME.fullmatch(family) else None
    for d in SEARCHED:
        path = Path(d) / f"{stem}.py"
        if stem is not None and path.is_file():
            spec = importlib.util.spec_from_file_location(f"{__name__}.{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise SystemExit(f"no encoder family {family!r}: looked for {stem or '<family>'}.py in "
                     f"{', '.join(str(d) for d in SEARCHED)}")


def of(cfg: dict) -> ModuleType:
    """The family of ``cfg``."""
    return load(name_of(cfg))
