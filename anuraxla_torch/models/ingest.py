"""Torch-checkpoint ingest — the port of ``anuraxla/models/ingest.py``:
convert a torch encoder ``state_dict`` into the JAX package's param tree of
``ConvVAEEncoder`` (numpy), which ``models.convert.encoder_state_from_jax``
carries into the port's ``state_dict``.

The reference loads a pretrained torch encoder checkpoint (pickled module or
raw / wrapped state_dict, ``map_detector_core.py:124-132``) whose
architecture comes from a private package. This module maps the documented
layer vocabulary (Conv2d, Linear, GroupNorm) with the layout conversions the
JAX package's tree holds:

- Conv2d weight  [O, I, kH, kW]  ->  kernel [kH, kW, I, O]
- Linear weight  [O, I]          ->  kernel [I, O]
- GroupNorm weight/bias          ->  scale/bias

``torch_twin_encoder()`` builds a torch module architecture-identical to
``ConvVAEEncoder`` (XLA 'SAME' asymmetric padding on stride-2 convs
included), which tests use to show converted weights reproduce its latents,
and users as the template their own checkpoints must map onto.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from anuraxla_torch.models.vae import VAEConfig


def split_model_and_state(ckpt: Any):
    """Accept the checkpoint containers the reference accepts
    (``map_detector_core.py:124-132``): a module (-> its state_dict), a dict
    with 'state_dict', or a raw tensor dict."""
    if isinstance(ckpt, torch.nn.Module):
        return ckpt.state_dict()
    if isinstance(ckpt, Mapping):
        if "state_dict" in ckpt and isinstance(ckpt["state_dict"], Mapping):
            return dict(ckpt["state_dict"])
        return dict(ckpt)
    raise ValueError(f"unsupported checkpoint container: {type(ckpt)}")


def _to_np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def convert_conv(w, b) -> Dict[str, np.ndarray]:
    return {"kernel": _to_np(w).transpose(2, 3, 1, 0), "bias": _to_np(b)}


def convert_linear(w, b) -> Dict[str, np.ndarray]:
    return {"kernel": _to_np(w).T, "bias": _to_np(b)}


def convert_groupnorm(w, b) -> Dict[str, np.ndarray]:
    return {"scale": _to_np(w), "bias": _to_np(b)}


def torch_state_dict_to_flax(sd: Mapping[str, Any], cfg: VAEConfig) -> Dict[str, Any]:
    """Map a twin-naming torch state_dict onto the JAX package's
    ConvVAEEncoder param tree (numpy).

    Expected torch names (see ``torch_twin_encoder``):
      blocks.{i}.conv1/gn1/conv2/gn2 . weight/bias
      dense.weight/bias, head_mu.weight/bias, head_logvar.weight/bias
    """
    params: Dict[str, Any] = {}
    for i in range(len(cfg.widths)):
        blk = {}
        blk["Conv_0"] = convert_conv(sd[f"blocks.{i}.conv1.weight"], sd[f"blocks.{i}.conv1.bias"])
        blk["GroupNorm_0"] = convert_groupnorm(sd[f"blocks.{i}.gn1.weight"], sd[f"blocks.{i}.gn1.bias"])
        blk["Conv_1"] = convert_conv(sd[f"blocks.{i}.conv2.weight"], sd[f"blocks.{i}.conv2.bias"])
        blk["GroupNorm_1"] = convert_groupnorm(sd[f"blocks.{i}.gn2.weight"], sd[f"blocks.{i}.gn2.bias"])
        params[f"EncoderBlock_{i}"] = blk
    params["Dense_0"] = convert_linear(sd["dense.weight"], sd["dense.bias"])
    params["head_mu"] = convert_linear(sd["head_mu.weight"], sd["head_mu.bias"])
    params["head_logvar"] = convert_linear(sd["head_logvar.weight"], sd["head_logvar.bias"])
    return {"params": params}


def torch_twin_encoder(cfg: VAEConfig):
    """Torch module numerically identical to ConvVAEEncoder (eval mode).

    Padding note: XLA 'SAME' for kernel 3, stride 2 on an even-size axis pads
    (low=0, high=1); torch's padding=1 would pad (1, 1). The twin uses explicit
    asymmetric F.pad to match XLA exactly.
    """
    import torch.nn as torch_nn
    import torch.nn.functional as F

    class Block(torch_nn.Module):
        def __init__(self, cin, w, groups):
            super().__init__()
            self.conv1 = torch_nn.Conv2d(cin, w, 3, stride=2, padding=0)
            # eps=1e-6 matches flax.linen.GroupNorm's default (torch's is 1e-5)
            self.gn1 = torch_nn.GroupNorm(min(groups, w), w, eps=1e-6)
            self.conv2 = torch_nn.Conv2d(w, w, 3, stride=1, padding=1)
            self.gn2 = torch_nn.GroupNorm(min(groups, w), w, eps=1e-6)

        def forward(self, x):
            x = F.pad(x, (0, 1, 0, 1))  # XLA SAME, stride 2, even dims
            x = F.silu(self.gn1(self.conv1(x)))
            return F.silu(self.gn2(self.conv2(x)))

    class Twin(torch_nn.Module):
        def __init__(self):
            super().__init__()
            widths = list(cfg.widths)
            chans = [1] + widths
            self.blocks = torch_nn.ModuleList(
                [Block(chans[i], chans[i + 1], cfg.groups) for i in range(len(widths))]
            )
            bt, bm = cfg.bottleneck_hw
            self.dense = torch_nn.Linear(bt * bm * widths[-1], cfg.dense_width)
            self.head_mu = torch_nn.Linear(cfg.dense_width, cfg.latent_dim)
            self.head_logvar = torch_nn.Linear(cfg.dense_width, cfg.latent_dim)

        def forward(self, x):  # x: [B, 1, T, M] (torch NCHW)
            for b in self.blocks:
                x = b(x)
            # flax flattens NHWC [B,T,M,C]; torch is NCHW -> permute first
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            x = F.silu(self.dense(x))
            return {"z": self.head_mu(x), "mu": self.head_mu(x), "logvar": self.head_logvar(x)}

    return Twin()
