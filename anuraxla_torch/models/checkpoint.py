"""Encoder artifacts without flax — the port of the serving half of
``anuraxla/models/checkpoint.py`` (``save_encoder``, ``load_encoder``,
``default_encoder_artifact``, ``load_or_init_encoder``).

The artifact is the JAX package's own, so either package reads what the
other wrote:
    <dir>/encoder.msgpack   the flax param tree, in flax's msgpack format
    <dir>/encoder.json      the VAEConfig fields
The msgpack bytes are read and written by ``utils.msgpack_codec`` (the
card's machine has neither ``flax`` nor ``msgpack``), and the weights pass
through ``models.convert`` (flax layout <-> ``state_dict``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from anuraxla_torch.constants import DEFAULT_ENCODER_DIR
from anuraxla_torch.models.convert import encoder_params_for_jax, encoder_state_from_jax
from anuraxla_torch.models.vae import VAEConfig, init_encoder_params
from anuraxla_torch.utils import msgpack_codec

log = logging.getLogger(__name__)


def _cfg_to_dict(cfg: VAEConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["widths"] = list(cfg.widths)
    d["input_hw"] = list(cfg.input_hw)
    d["dtype"] = str(cfg.dtype).replace("torch.", "")
    return d


def _cfg_from_dict(d: dict) -> VAEConfig:
    d = dict(d)
    d["widths"] = tuple(d["widths"])
    d["input_hw"] = tuple(d["input_hw"])
    d["dtype"] = d.get("dtype", "float32")
    return VAEConfig(**d)


def save_encoder(dir_path: str | Path, cfg: VAEConfig, state: Dict[str, torch.Tensor]) -> Path:
    """Write the port's ``state_dict`` as the JAX package's artifact."""
    dir_path = Path(dir_path)
    dir_path.mkdir(parents=True, exist_ok=True)
    (dir_path / "encoder.msgpack").write_bytes(msgpack_codec.packb(encoder_params_for_jax(state, cfg)))
    (dir_path / "encoder.json").write_text(json.dumps(_cfg_to_dict(cfg), indent=2))
    return dir_path


def load_encoder(dir_path: str | Path) -> Tuple[Dict[str, torch.Tensor], VAEConfig]:
    """-> (``state_dict``, cfg) of an artifact written by either package."""
    dir_path = Path(dir_path)
    cfg = _cfg_from_dict(json.loads((dir_path / "encoder.json").read_text()))
    params = msgpack_codec.unpackb((dir_path / "encoder.msgpack").read_bytes())
    return encoder_state_from_jax(params, cfg), cfg


def default_encoder_artifact(project_root: Path) -> Path:
    """``models/anuraxla_vae_encoder_v0`` under the project root."""
    return Path(project_root) / DEFAULT_ENCODER_DIR


def load_or_init_encoder(
    encoder_dir: str | Path | None,
    project_root: Path,
    *,
    seed: int = 0,
    cfg: Optional[VAEConfig] = None,
) -> Tuple[Dict[str, torch.Tensor], VAEConfig]:
    """The reference's resolution: an explicit dir wins, else the default
    artifact under ``project_root``; with neither, a seeded init of ``cfg``
    (default ``VAEConfig()``) with one warning line — torch's generator, not
    flax's init RNG, so the JAX package's fallback serves other weights."""
    if encoder_dir is not None:
        return load_encoder(encoder_dir)
    default = default_encoder_artifact(project_root)
    if (default / "encoder.msgpack").exists():
        return load_encoder(default)
    cfg = cfg if cfg is not None else VAEConfig()
    log.warning("⚠️ no encoder artifact (--encoder, or %s): serving a seeded random init (seed %d) that is "
                "not the JAX package's fallback encoder", default, seed)
    return init_encoder_params(cfg, torch.Generator().manual_seed(seed)), cfg
