"""Weights carried across from the JAX package: the inverse of
``anuraxla/models/ingest.py``'s torch -> flax mapping.

``encoder_state_from_jax(params_np, cfg)`` takes the flax ``ConvVAEEncoder``
param tree as numpy arrays (``{"params": {"EncoderBlock_0": {"Conv_0":
{"kernel", "bias"}, "GroupNorm_0": {"scale", "bias"}, ...}, "Dense_0", "head_mu",
"head_logvar"}}``, with or without the outer ``"params"`` key) and returns
a ``state_dict`` for the port's ``ConvVAEEncoder``:

- conv kernel [kH, kW, I, O] -> weight [O, I, kH, kW]
- dense kernel [I, O]        -> weight [O, I]
- GroupNorm scale/bias        -> weight/bias
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from anuraxla_torch.models.vae import VAEConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def encoder_state_from_jax(params_np: Mapping[str, Any], cfg: VAEConfig) -> Dict[str, torch.Tensor]:
    p = params_np.get("params", params_np)
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(cfg.widths)):
        blk = p[f"EncoderBlock_{i}"]
        for j in (0, 1):
            conv = blk[f"Conv_{j}"]
            sd[f"blocks.{i}.conv{j + 1}.weight"] = _t(np.transpose(conv["kernel"], (3, 2, 0, 1)))
            sd[f"blocks.{i}.conv{j + 1}.bias"] = _t(conv["bias"])
            if cfg.norm == "group":
                gn = blk[f"GroupNorm_{j}"]
                sd[f"blocks.{i}.gn{j + 1}.weight"] = _t(gn["scale"])
                sd[f"blocks.{i}.gn{j + 1}.bias"] = _t(gn["bias"])
    for src, dst in (("Dense_0", "dense"), ("head_mu", "head_mu"), ("head_logvar", "head_logvar")):
        sd[f"{dst}.weight"] = _t(np.asarray(p[src]["kernel"]).T)
        sd[f"{dst}.bias"] = _t(p[src]["bias"])
    return sd
