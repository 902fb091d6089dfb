"""Artifacts and train-state checkpoints without flax — the port of
``anuraxla/models/checkpoint.py``.

The conv-VAE artifacts are the JAX package's own, so either package reads
what the other wrote:
    <dir>/encoder.msgpack + encoder.json   an encoder (the VAEConfig fields)
    <dir>/vae.msgpack + encoder.json       a full ConvVAE, native decoder
    <dir>/decoder.msgpack + decoder.json   an IngestedDecoder (DecoderSpec fields)
The msgpack bytes are read and written by ``utils.msgpack_codec`` (the
card's machine has neither ``flax`` nor ``msgpack``), and the weights pass
through ``models.convert`` (flax layout <-> ``state_dict``). An AST encoder
(``models.ast``; the JAX package has none) is the port's own artifact under
the same two names: ``encoder.json`` holds the ``ASTConfig`` fields and
``"arch": "ast"``, ``encoder.msgpack`` a flat map of the port's
``state_dict`` names to f32 arrays.

Train-state checkpoints are the port's own format and do not interchange
with the JAX package's orbax checkpoints: ``<ckpt_dir>/<step>/train_state.pt``
(``torch.save`` of the model's ``state_dict``, the AdamW state and the step,
which is also the count the learning-rate schedule reads); the latest step
wins on restore.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from anuraxla_torch.constants import DEFAULT_ENCODER_DIR
from anuraxla_torch.models.ast import ASTConfig, ASTEncoder, init_ast_params
from anuraxla_torch.models.convert import (
    encoder_params_for_jax, encoder_state_from_jax, ingested_decoder_slots, params_for_jax, state_from_jax, vae_slots,
)
from anuraxla_torch.models.vae import ConvVAEEncoder, DecoderSpec, VAEConfig, init_encoder_params
from anuraxla_torch.utils import msgpack_codec

log = logging.getLogger(__name__)


class Family(NamedTuple):
    """An encoder family: its module, ``encoder.json``'s ``"arch"`` (None: the
    JAX package's conv-VAE artifact), the artifact's writer and reader, the seeded init."""

    encoder: type
    arch: Optional[str]
    write: Callable
    read: Callable
    init: Callable


# every encoder family, by its config class: adding one is its model module and an entry here
EncoderConfig = Union[VAEConfig, ASTConfig]  # the keys of FAMILIES
FAMILIES = {
    VAEConfig: Family(ConvVAEEncoder, None, encoder_params_for_jax, encoder_state_from_jax, init_encoder_params),
    ASTConfig: Family(ASTEncoder, "ast",  # a flat map of the state_dict's names to f32 arrays
                      lambda state, _: {k: v.detach().cpu().to(torch.float32).numpy() for k, v in state.items()},
                      lambda tree, _: {k: torch.from_numpy(np.array(v, np.float32)) for k, v in tree.items()},
                      init_ast_params),
}


def family_of(cfg: EncoderConfig) -> Family:
    """The family of an encoder config; TypeError for a config no family has."""
    fam = FAMILIES.get(type(cfg))
    if fam is None:
        raise TypeError(f"no encoder serves a {type(cfg).__name__} (known: {[c.__name__ for c in FAMILIES]})")
    return fam


def cfg_to_dict(cfg: EncoderConfig) -> dict:
    """An encoder config as ``encoder.json`` holds it (lists, the dtype's
    name, then the family's ``"arch"`` where it has one)."""
    d = {k: list(v) if isinstance(v, (tuple, list)) else v for k, v in dataclasses.asdict(cfg).items()}
    d["dtype"] = str(cfg.dtype).replace("torch.", "")
    arch = family_of(cfg).arch
    return d if arch is None else {**d, "arch": arch}


def _cfg_from_dict(d: dict) -> EncoderConfig:
    d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
    d["dtype"] = d.get("dtype", "float32")
    arch = d.pop("arch", None)
    cls = next((c for c, fam in FAMILIES.items() if fam.arch == arch), None)
    if cls is None:
        raise ValueError(f"encoder.json names arch {arch!r}, which no encoder family has")
    return cls(**d)


def save_encoder(dir_path: str | Path, cfg: EncoderConfig, state: Dict[str, torch.Tensor]) -> Path:
    """Write the port's ``state_dict`` in its family's artifact: the JAX
    package's for a conv-VAE, the port's own for an AST encoder."""
    dir_path = Path(dir_path)
    dir_path.mkdir(parents=True, exist_ok=True)
    (dir_path / "encoder.msgpack").write_bytes(msgpack_codec.packb(family_of(cfg).write(state, cfg)))
    (dir_path / "encoder.json").write_text(json.dumps(cfg_to_dict(cfg), indent=2))
    return dir_path


def load_encoder(dir_path: str | Path) -> Tuple[Dict[str, torch.Tensor], EncoderConfig]:
    """-> (``state_dict``, cfg) of an artifact written by either package, or
    of the port's AST artifact."""
    dir_path = Path(dir_path)
    cfg = _cfg_from_dict(json.loads((dir_path / "encoder.json").read_text()))
    params = msgpack_codec.unpackb((dir_path / "encoder.msgpack").read_bytes())
    return family_of(cfg).read(params, cfg), cfg


def save_vae(dir_path: str | Path, cfg: VAEConfig, state: Dict[str, torch.Tensor]) -> Path:
    """Full ``ConvVAE`` (native decoder) artifact: ``vae.msgpack`` + ``encoder.json``."""
    dir_path = Path(dir_path)
    dir_path.mkdir(parents=True, exist_ok=True)
    (dir_path / "vae.msgpack").write_bytes(msgpack_codec.packb(params_for_jax(state, vae_slots(cfg))))
    (dir_path / "encoder.json").write_text(json.dumps(cfg_to_dict(cfg), indent=2))
    return dir_path


def load_vae(dir_path: str | Path) -> Tuple[Dict[str, torch.Tensor], VAEConfig]:
    """-> (``ConvVAE`` ``state_dict``, cfg)."""
    dir_path = Path(dir_path)
    cfg = _cfg_from_dict(json.loads((dir_path / "encoder.json").read_text()))
    params = msgpack_codec.unpackb((dir_path / "vae.msgpack").read_bytes())
    return state_from_jax(params, vae_slots(cfg)), cfg


def save_decoder(dir_path: str | Path, spec: DecoderSpec, state: Dict[str, torch.Tensor]) -> Path:
    """``IngestedDecoder`` artifact: ``decoder.msgpack`` + ``decoder.json``."""
    dir_path = Path(dir_path)
    dir_path.mkdir(parents=True, exist_ok=True)
    d = dataclasses.asdict(spec)
    d["dense_widths"] = list(spec.dense_widths)
    d["bottleneck_hw"] = list(spec.bottleneck_hw)
    d["stack"] = [list(s) for s in spec.stack]
    (dir_path / "decoder.msgpack").write_bytes(msgpack_codec.packb(params_for_jax(state, ingested_decoder_slots(spec))))
    (dir_path / "decoder.json").write_text(json.dumps(d, indent=2))
    return dir_path


def load_decoder(dir_path: str | Path) -> Tuple[Dict[str, torch.Tensor], DecoderSpec]:
    """-> (``IngestedDecoder`` ``state_dict``, spec)."""
    dir_path = Path(dir_path)
    d = json.loads((dir_path / "decoder.json").read_text())
    d["dense_widths"] = tuple(d["dense_widths"])
    d["bottleneck_hw"] = tuple(d["bottleneck_hw"])
    d["stack"] = tuple((str(k), int(w)) for k, w in d["stack"])
    spec = DecoderSpec(**d)
    params = msgpack_codec.unpackb((dir_path / "decoder.msgpack").read_bytes())
    return state_from_jax(params, ingested_decoder_slots(spec)), spec


TRAIN_STATE_FILE = "train_state.pt"


def save_train_state(ckpt_dir: str | Path, state, step: Optional[int] = None) -> Path:
    """Write ``state`` (a ``models.train.TrainState``) to
    ``<ckpt_dir>/<step>/train_state.pt``, through a temporary file so that a
    cut run leaves no partial checkpoint behind."""
    d = Path(ckpt_dir) / str(int(state.step if step is None else step))
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / (TRAIN_STATE_FILE + ".tmp")
    torch.save({"step": int(state.step), "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}, tmp)
    tmp.replace(d / TRAIN_STATE_FILE)
    return d


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    d = Path(ckpt_dir)
    steps = [int(p.name) for p in d.iterdir() if p.name.isdigit() and (p / TRAIN_STATE_FILE).is_file()] \
        if d.is_dir() else []
    return max(steps, default=None)


def restore_train_state(ckpt_dir: str | Path, template_state):
    """Load the latest step under ``ckpt_dir`` into ``template_state`` (from
    ``models.train.create_train_state`` of the same architecture, on the
    device to train on) and return it."""
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    device = next(template_state.model.parameters()).device
    blob = torch.load(Path(ckpt_dir) / str(step) / TRAIN_STATE_FILE, map_location=device, weights_only=True)
    template_state.model.load_state_dict(blob["model"])
    template_state.optimizer.load_state_dict(blob["optimizer"])
    template_state.step = int(blob["step"])
    return template_state


def default_encoder_artifact(project_root: Path) -> Path:
    """``models/anuraxla_vae_encoder_v0`` under the project root."""
    return Path(project_root) / DEFAULT_ENCODER_DIR


def load_or_init_encoder(encoder_dir: str | Path | None, project_root: Path, *, seed: int = 0,
                         cfg: Optional[EncoderConfig] = None) -> Tuple[Dict[str, torch.Tensor], EncoderConfig]:
    """The reference's resolution: an explicit dir wins, else the default
    artifact under ``project_root``; with neither, a seeded init of ``cfg``
    (default ``VAEConfig()``) by its family's init, with
    one warning line — torch's generator, not flax's init RNG, so the JAX
    package's fallback serves other weights."""
    if encoder_dir is not None:
        return load_encoder(encoder_dir)
    default = default_encoder_artifact(project_root)
    if (default / "encoder.msgpack").exists():
        return load_encoder(default)
    cfg = cfg if cfg is not None else VAEConfig()
    log.warning("⚠️ no encoder artifact (--encoder, or %s): serving a seeded random init (seed %d) that is "
                "not the JAX package's fallback encoder", default, seed)
    return family_of(cfg).init(cfg, torch.Generator().manual_seed(seed)), cfg
