"""Conv-VAE encoder — the port of ``anuraxla/models/vae.py``'s serving half
(``VAEConfig``, ``bottleneck_for``, ``EncoderBlock``, ``ConvVAEEncoder``).

The public boundary keeps the reference's NHWC layout ([B, T, M, 1] in);
inside, the trunk runs NCHW as PyTorch convolutions expect. Parameters stay
f32. ``dtype="bfloat16"`` runs the trunk (convs, GroupNorm output, Dense_0)
in bf16 with the mu/logvar heads in f32, as the reference's served tier.
In f32 the forward runs with TF32 off (``utils.precision.exact_f32``).

Traps the port pins (tests hold it to the flax module):
- XLA SAME padding on a stride-2 conv is asymmetric and depends on the input
  size; it is computed per call (``same_pads``), never hard-coded;
- flax flattens NHWC before ``Dense_0``, so the trunk output is permuted back
  to NHWC before the flatten;
- GroupNorm's eps comes from the config (flax's default is 1e-6).

Covered: ``downsample="stride"``, ``norm`` group/none, ``conv_padding``
SAME/TORCH. The ``avgpool`` family is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from anuraxla_torch.utils.precision import exact_f32

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype!r}") from None


def bottleneck_for(t: int, m: int, n_blocks: int, downsample: str = "stride") -> tuple[int, int]:
    """Output (T, M) after n_blocks of downsampling: "stride" halves with
    ceil, "avgpool" with floor."""
    for _ in range(n_blocks):
        if downsample == "avgpool":
            t, m = t // 2, m // 2
        else:
            t, m = -(-t // 2), -(-m // 2)
    return t, m


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Architecture hyperparameters (defaults: ~7.6 M-param encoder,
    [B,192,64,1] -> 128-d latent). ``dtype`` is the trunk compute dtype, a
    string ("float32" / "bfloat16") or a torch dtype."""

    latent_dim: int = 128
    widths: Sequence[int] = (32, 64, 128, 256)
    dense_width: int = 512
    groups: int = 8
    input_hw: tuple[int, int] = (192, 64)  # (T, M)
    dtype: object = "float32"
    conv_padding: str = "SAME"  # "SAME" (XLA) | "TORCH" (symmetric 1,1)
    gn_eps: float = 1e-6
    activation: str = "silu"
    norm: str = "group"  # "group" | "none"
    downsample: str = "stride"

    @property
    def bottleneck_hw(self) -> tuple[int, int]:
        return bottleneck_for(*self.input_hw, len(self.widths), self.downsample)


def same_pads(size: int, stride: int, k: int = 3) -> tuple[int, int]:
    """XLA SAME padding (low, high) for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    lo = total // 2
    return lo, total - lo


class EncoderBlock(nn.Module):
    """Stride-2 3x3 conv + norm + act, stride-1 3x3 conv + norm + act."""

    def __init__(self, cin: int, width: int, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        g = min(cfg.groups, width)
        self.conv1 = nn.Conv2d(cin, width, 3, stride=2, padding=0)
        self.conv2 = nn.Conv2d(width, width, 3, stride=1, padding=0)
        if cfg.norm == "group":
            self.gn1 = nn.GroupNorm(g, width, eps=cfg.gn_eps)
            self.gn2 = nn.GroupNorm(g, width, eps=cfg.gn_eps)
        elif cfg.norm != "none":
            raise ValueError(f"norm must be 'group' or 'none', got {cfg.norm!r}")
        self.act = getattr(F, cfg.activation)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor, pads) -> torch.Tensor:
        (pt, pb), (pl, pr) = pads
        x = F.pad(x, (pl, pr, pt, pb))
        return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), stride=conv.stride)

    def _norm(self, gn: nn.GroupNorm | None, x: torch.Tensor) -> torch.Tensor:
        if gn is None:
            return x
        # statistics in f32 (as flax), output in the trunk dtype
        return F.group_norm(x.float(), gn.num_groups, gn.weight, gn.bias, gn.eps).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        if self.cfg.conv_padding == "TORCH":
            pads = ((1, 1), (1, 1))
        elif self.cfg.conv_padding == "SAME":
            pads = (same_pads(h, 2), same_pads(w, 2))
        else:
            raise ValueError(f"conv_padding must be SAME or TORCH, got {self.cfg.conv_padding!r}")
        x = self.act(self._norm(getattr(self, "gn1", None), self._conv(self.conv1, x, pads)))
        # stride-1 k3: torch padding=1 and XLA SAME agree
        x = self._conv(self.conv2, x, ((1, 1), (1, 1)))
        return self.act(self._norm(getattr(self, "gn2", None), x))


class ConvVAEEncoder(nn.Module):
    """[B, T, M, 1] log-mel -> {"z", "mu", "logvar"} (eval: z == mu)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        if cfg.downsample != "stride":
            raise NotImplementedError("the avgpool encoder family is not ported yet")
        self.cfg = cfg
        self.dtype = as_torch_dtype(cfg.dtype)
        chans = [1] + list(cfg.widths)
        self.blocks = nn.ModuleList(
            [EncoderBlock(chans[i], chans[i + 1], cfg) for i in range(len(cfg.widths))]
        )
        bt, bm = cfg.bottleneck_hw
        self.dense = nn.Linear(bt * bm * cfg.widths[-1], cfg.dense_width)
        self.head_mu = nn.Linear(cfg.dense_width, cfg.latent_dim)
        self.head_logvar = nn.Linear(cfg.dense_width, cfg.latent_dim)
        self.act = getattr(F, cfg.activation)

    def _forward(self, x: torch.Tensor) -> dict:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW
        for blk in self.blocks:
            x = blk(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax flattens NHWC
        x = self.act(F.linear(x, self.dense.weight.to(x.dtype), self.dense.bias.to(x.dtype)))
        x = x.float()
        mu = self.head_mu(x)
        return {"z": mu, "mu": mu, "logvar": self.head_logvar(x)}

    def forward(self, x: torch.Tensor) -> dict:
        with exact_f32():
            return self._forward(x)


def init_encoder_params(cfg: VAEConfig, generator: torch.Generator) -> dict:
    """Seeded random weights for ``ConvVAEEncoder(cfg).load_state_dict`` —
    normal with std 1/sqrt(fan_in) for convs and dense layers (flax's lecun
    scale), zero biases, unit GroupNorm scales."""
    sd = ConvVAEEncoder(cfg).state_dict()
    out = {}
    for name, t in sd.items():
        if name.endswith(".bias"):
            out[name] = torch.zeros_like(t)
        elif ".gn" in name:
            out[name] = torch.ones_like(t)
        else:
            fan_in = math.prod(t.shape[1:])
            out[name] = torch.randn(t.shape, generator=generator) / math.sqrt(fan_in)
    return out
