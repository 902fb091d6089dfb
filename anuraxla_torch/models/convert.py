"""Weights carried across from and to the JAX package: the flax param trees
of ``ConvVAEEncoder``, ``ConvVAEDecoder``, ``IngestedDecoder`` and the full
``ConvVAE`` (``{"encoder", "decoder"}``), as numpy arrays, and the port's
``state_dict``s, both ways.

Each module's layers are listed once as slots — (flax path, ``state_dict``
prefix, kind) — and one pair of functions carries every slot by its kind:

- conv kernel [kH, kW, I, O]   <-> weight [O, I, kH, kW]
- convt kernel [kH, kW, I, O]  <-> weight [I, O, kH, kW], flipped in kH and
  kW (flax's ConvTranspose correlates with its kernel unflipped; the port
  runs ``conv_transpose2d``, which flips it; ``models.vae``)
- dense kernel [I, O]          <-> weight [O, I]
- GroupNorm scale/bias         <-> weight/bias

``*_from_jax`` take the tree with or without the outer ``"params"`` key;
``*_for_jax`` return it under ``"params"``, as flax's ``to_bytes`` of the
JAX package's params writes it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from anuraxla_torch.models.vae import DecoderSpec, VAEConfig

Slot = Tuple[Tuple[str, ...], str, str]  # (flax path, state_dict prefix, kind)


def encoder_slots(cfg: VAEConfig) -> Iterator[Slot]:
    convs = (0,) if cfg.downsample == "avgpool" else (0, 1)
    for i in range(len(cfg.widths)):
        for j in convs:
            yield (f"EncoderBlock_{i}", f"Conv_{j}"), f"blocks.{i}.conv{j + 1}", "conv"
            if cfg.norm == "group":
                yield (f"EncoderBlock_{i}", f"GroupNorm_{j}"), f"blocks.{i}.gn{j + 1}", "norm"
    for src, dst in (("Dense_0", "dense"), ("head_mu", "head_mu"), ("head_logvar", "head_logvar")):
        yield (src,), dst, "dense"


def decoder_slots(cfg: VAEConfig) -> Iterator[Slot]:
    yield ("Dense_0",), "dense0", "dense"
    yield ("Dense_1",), "dense1", "dense"
    for i in range(len(cfg.widths) - 1):
        blk = f"DecoderBlock_{i}"
        yield (blk, "ConvTranspose_0"), f"blocks.{i}.convt", "convt"
        yield (blk, "GroupNorm_0"), f"blocks.{i}.gn1", "norm"
        yield (blk, "Conv_0"), f"blocks.{i}.conv", "conv"
        yield (blk, "GroupNorm_1"), f"blocks.{i}.gn2", "norm"
    yield ("ConvTranspose_0",), "convt", "convt"
    yield ("Conv_0",), "out", "conv"


def ingested_decoder_slots(spec: DecoderSpec) -> Iterator[Slot]:
    for i in range(len(spec.dense_widths)):
        yield (f"Dense_{i}",), f"dense.{i}", "dense"
    last = len(spec.stack) - 1
    for i, (kind, _) in enumerate(spec.stack):
        yield (f"Layer_{i}",), f"layers.{i}", "convt" if kind == "convt" else "conv"
        if i < last and spec.norm == "group":
            yield (f"Norm_{i}",), f"norms.{i}", "norm"


def vae_slots(cfg: VAEConfig, spec: Optional[DecoderSpec] = None) -> Iterator[Slot]:
    for path, name, kind in encoder_slots(cfg):
        yield ("encoder", *path), f"encoder.{name}", kind
    dec = decoder_slots(cfg) if spec is None else ingested_decoder_slots(spec)
    for path, name, kind in dec:
        yield ("decoder", *path), f"decoder.{name}", kind


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _weight_from_jax(kernel: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.transpose(kernel, (3, 2, 0, 1))
    if kind == "convt":
        return np.transpose(kernel[::-1, ::-1], (2, 3, 0, 1))
    return np.asarray(kernel).T  # dense


def _kernel_for_jax(weight: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.transpose(weight, (2, 3, 1, 0))
    if kind == "convt":
        return np.ascontiguousarray(np.transpose(weight, (2, 3, 0, 1))[::-1, ::-1])
    return weight.T  # dense


def state_from_jax(params_np: Mapping[str, Any], slots) -> Dict[str, torch.Tensor]:
    """flax param tree -> ``state_dict`` over ``slots``."""
    p = params_np.get("params", params_np)
    sd: Dict[str, torch.Tensor] = {}
    for path, name, kind in slots:
        leaf = p
        for key in path:
            leaf = leaf[key]
        if kind == "norm":
            sd[f"{name}.weight"] = _t(leaf["scale"])
        else:
            sd[f"{name}.weight"] = _t(_weight_from_jax(np.asarray(leaf["kernel"]), kind))
        sd[f"{name}.bias"] = _t(leaf["bias"])
    return sd


def params_for_jax(state: Mapping[str, torch.Tensor], slots) -> Dict[str, Any]:
    """``state_dict`` -> flax param tree (numpy, under ``"params"``) over ``slots``."""
    def a(name: str) -> np.ndarray:
        return state[name].detach().cpu().to(torch.float32).numpy()

    p: Dict[str, Any] = {}
    for path, name, kind in slots:
        node = p
        for key in path[:-1]:
            node = node.setdefault(key, {})
        w = a(f"{name}.weight")
        node[path[-1]] = ({"scale": w} if kind == "norm" else {"kernel": _kernel_for_jax(w, kind)}) \
            | {"bias": a(f"{name}.bias")}
    return {"params": p}


def encoder_state_from_jax(params_np: Mapping[str, Any], cfg: VAEConfig) -> Dict[str, torch.Tensor]:
    return state_from_jax(params_np, encoder_slots(cfg))


def encoder_params_for_jax(state: Mapping[str, torch.Tensor], cfg: VAEConfig) -> Dict[str, Any]:
    return params_for_jax(state, encoder_slots(cfg))
