"""Conv VAE — the port of ``anuraxla/models/vae.py`` (``VAEConfig``,
``bottleneck_for``, ``EncoderBlock``, ``ConvVAEEncoder``, ``DecoderBlock``,
``ConvVAEDecoder``, ``DecoderSpec``, ``IngestedDecoder``, ``ConvVAE``,
``init_vae``, ``encoder_params_from_vae``).

The public boundary keeps the reference's NHWC layout ([B, T, M, 1] in and
out); inside, the trunks run NCHW as PyTorch convolutions expect. Parameters
stay f32. ``dtype="bfloat16"`` runs the trunks (convs, GroupNorm output, the
trunk's dense layers) in bf16 with the mu/logvar heads and the decoder's
output conv in f32, as the reference does. In f32 every forward runs with
TF32 off (``utils.precision.exact_f32``); a train step holds it off across
the backward and the optimizer too (``models.train``).

Traps the port pins (tests hold it to the flax modules):
- XLA SAME padding on a stride-2 conv is asymmetric and depends on the input
  size; it is computed per call (``same_pads``), never hard-coded;
- flax flattens NHWC before ``Dense_0`` and reshapes NHWC after the decoder's
  ``Dense_1``, so the trunks permute at those points;
- the encoder's GroupNorm eps comes from the config (flax's default is 1e-6);
  the native decoder's is flax's default and its activations are silu,
  whatever the config says;
- flax's ``ConvTranspose(4x4, stride 2, "SAME")`` correlates the dilated
  input with its kernel unflipped: the port stores the flipped kernel
  (``models.convert``) and runs ``conv_transpose2d(stride=2, padding=1)``,
  which gives the same output, 2x the input at any size;
- flax's ``gelu`` is the tanh form.

Covered: ``downsample`` stride/avgpool, ``norm`` group/none,
``conv_padding`` SAME/TORCH, the native decoder and every ``DecoderSpec``
stack kind (convt, upconv, conv) with norm group/none. Seeded weights come
from a ``torch.Generator``, not flax's init RNG.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence

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


def activation(name: str):
    """The torch function of a flax activation name."""
    if name == "gelu":
        return functools.partial(F.gelu, approximate="tanh")  # flax's gelu default
    return getattr(F, name)


def conv(layer: nn.Conv2d, x: torch.Tensor, pads=((1, 1), (1, 1))) -> torch.Tensor:
    """``layer`` in ``x``'s dtype with explicit (top, bottom), (left, right) pads."""
    (pt, pb), (pl, pr) = pads
    if pt == pb and pl == pr:
        return F.conv2d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype), stride=layer.stride, padding=(pt, pl))
    x = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype), stride=layer.stride)


def conv_transpose(layer: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """flax ``ConvTranspose(4x4, stride 2, "SAME")`` with the kernel stored
    flipped: out = 2x in."""
    return F.conv_transpose2d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype), stride=2, padding=1)


def dense(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``layer`` in ``x``'s dtype; a layer split over devices
    (``parallel.train_sharded.ColumnSplitDense``) computes its own."""
    if not isinstance(layer, nn.Linear):
        return layer(x)
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def group_norm(gn: Optional[nn.GroupNorm], x: torch.Tensor) -> torch.Tensor:
    """Statistics in f32 (as flax), output in the trunk dtype."""
    if gn is None:
        return x
    return F.group_norm(x.float(), gn.num_groups, gn.weight, gn.bias, gn.eps).to(x.dtype)


class EncoderBlock(nn.Module):
    """"stride": stride-2 3x3 conv + norm + act, stride-1 3x3 conv + norm +
    act. "avgpool": one stride-1 3x3 conv + norm + act, then a 2x2/2 VALID
    average pool, which floor-halves (the odd row or column is dropped)."""

    def __init__(self, cin: int, width: int, cfg: VAEConfig):
        super().__init__()
        if cfg.downsample not in ("stride", "avgpool"):
            raise ValueError(f"downsample must be 'stride' or 'avgpool', got {cfg.downsample!r}")
        if cfg.norm not in ("group", "none"):
            raise ValueError(f"norm must be 'group' or 'none', got {cfg.norm!r}")
        self.cfg = cfg
        self.avgpool = cfg.downsample == "avgpool"
        g = min(cfg.groups, width)
        self.conv1 = nn.Conv2d(cin, width, 3, stride=1 if self.avgpool else 2, padding=0)
        if cfg.norm == "group":
            self.gn1 = nn.GroupNorm(g, width, eps=cfg.gn_eps)
        if not self.avgpool:
            self.conv2 = nn.Conv2d(width, width, 3, stride=1, padding=0)
            if cfg.norm == "group":
                self.gn2 = nn.GroupNorm(g, width, eps=cfg.gn_eps)
        self.act = activation(cfg.activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.avgpool:
            x = self.act(group_norm(getattr(self, "gn1", None), conv(self.conv1, x)))
            return F.avg_pool2d(x, 2)
        h, w = x.shape[-2:]
        if self.cfg.conv_padding == "TORCH":
            pads = ((1, 1), (1, 1))
        elif self.cfg.conv_padding == "SAME":
            pads = (same_pads(h, 2), same_pads(w, 2))
        else:
            raise ValueError(f"conv_padding must be SAME or TORCH, got {self.cfg.conv_padding!r}")
        x = self.act(group_norm(getattr(self, "gn1", None), conv(self.conv1, x, pads)))
        # stride-1 k3: torch padding=1 and XLA SAME agree
        return self.act(group_norm(getattr(self, "gn2", None), conv(self.conv2, x)))


class ConvVAEEncoder(nn.Module):
    """[B, T, M, 1] log-mel -> {"z", "mu", "logvar"} (eval: z == mu)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
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
        self.act = activation(cfg.activation)

    def _forward(self, x: torch.Tensor) -> dict:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW
        for blk in self.blocks:
            x = blk(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax flattens NHWC
        x = self.act(dense(self.dense, x)).float()
        mu = self.head_mu(x)
        return {"z": mu, "mu": mu, "logvar": self.head_logvar(x)}

    def forward(self, x: torch.Tensor) -> dict:
        with exact_f32():
            return self._forward(x)


class DecoderBlock(nn.Module):
    """ConvTranspose 4x4/2 + GroupNorm + silu, 3x3 conv + GroupNorm + silu;
    GroupNorm eps is flax's default 1e-6 (``anuraxla/models/vae.py:150-162``)."""

    def __init__(self, cin: int, width: int, groups: int):
        super().__init__()
        g = min(groups, width)
        self.convt = nn.ConvTranspose2d(cin, width, 4, stride=2, padding=1)
        self.gn1 = nn.GroupNorm(g, width, eps=1e-6)
        self.conv = nn.Conv2d(width, width, 3, padding=1)
        self.gn2 = nn.GroupNorm(g, width, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(group_norm(self.gn1, conv_transpose(self.convt, x)))
        return F.silu(group_norm(self.gn2, conv(self.conv, x)))


class ConvVAEDecoder(nn.Module):
    """z [B, D] -> reconstructed log-mel [B, T', M', 1], T' x M' = the
    bottleneck times 2^len(widths) (the input size when no halving rounded)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = as_torch_dtype(cfg.dtype)
        bt, bm = cfg.bottleneck_hw
        w0 = cfg.widths[-1]
        self.dense0 = nn.Linear(cfg.latent_dim, cfg.dense_width)
        self.dense1 = nn.Linear(cfg.dense_width, bt * bm * w0)
        chans = [w0] + list(reversed(cfg.widths[:-1]))
        self.blocks = nn.ModuleList(
            [DecoderBlock(chans[i], chans[i + 1], cfg.groups) for i in range(len(chans) - 1)]
        )
        self.convt = nn.ConvTranspose2d(chans[-1], 16, 4, stride=2, padding=1)
        self.out = nn.Conv2d(16, 1, 3, padding=1)

    def _forward(self, z: torch.Tensor) -> torch.Tensor:
        bt, bm = self.cfg.bottleneck_hw
        x = F.silu(dense(self.dense0, z.to(self.dtype)))
        x = F.silu(dense(self.dense1, x)).reshape(-1, bt, bm, self.cfg.widths[-1]).permute(0, 3, 1, 2)
        for blk in self.blocks:
            x = blk(x)
        x = F.silu(conv_transpose(self.convt, x))
        return conv(self.out, x.float()).permute(0, 2, 3, 1)  # the output conv in f32

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        with exact_f32():
            return self._forward(z)


@dataclasses.dataclass(frozen=True)
class DecoderSpec:
    """Structure of an ingested foreign decoder (``anuraxla/models/vae.py:187``):
    ``dense_widths`` linear layers from the latent, a reshape to
    (``bottleneck_hw``, ``bottleneck_c``) NHWC, then ``stack`` entries of
    ("convt", w) = ConvTranspose(4x4, stride 2), ("upconv", w) = nearest x2
    upsample + Conv(3x3), ("conv", w) = Conv(3x3); norm and activation after
    every layer but the last (the output conv)."""

    latent_dim: int
    dense_widths: tuple[int, ...]
    bottleneck_hw: tuple[int, int]
    bottleneck_c: int
    stack: tuple[tuple[str, int], ...]
    norm: str = "group"
    groups: int = 8
    gn_eps: float = 1e-5
    activation: str = "silu"

    @property
    def out_hw(self) -> tuple[int, int]:
        n_up = sum(1 for kind, _ in self.stack if kind in ("convt", "upconv"))
        return (self.bottleneck_hw[0] * 2**n_up, self.bottleneck_hw[1] * 2**n_up)

    @property
    def out_channels(self) -> int:
        return self.stack[-1][1]


class IngestedDecoder(nn.Module):
    """z [B, D] -> [B, T, M, out_channels], replaying a ``DecoderSpec`` in f32
    throughout with ``spec.gn_eps`` and ``spec.activation``."""

    def __init__(self, spec: DecoderSpec):
        super().__init__()
        if spec.norm not in ("group", "none"):
            raise ValueError(f"norm must be 'group' or 'none', got {spec.norm!r}")
        self.spec = spec
        dims = [spec.latent_dim] + list(spec.dense_widths)
        self.dense = nn.ModuleList([nn.Linear(dims[i], dims[i + 1]) for i in range(len(dims) - 1)])
        self.layers = nn.ModuleList()
        self.norms = nn.ModuleDict()
        cin = spec.bottleneck_c
        for i, (kind, w) in enumerate(spec.stack):
            if kind == "convt":
                self.layers.append(nn.ConvTranspose2d(cin, w, 4, stride=2, padding=1))
            elif kind in ("upconv", "conv"):
                self.layers.append(nn.Conv2d(cin, w, 3, padding=1))
            else:
                raise ValueError(f"unknown stack kind {kind!r}")
            if i < len(spec.stack) - 1 and spec.norm == "group":
                self.norms[str(i)] = nn.GroupNorm(min(spec.groups, w), w, eps=spec.gn_eps)
            cin = w
        self.act = activation(spec.activation)

    def _forward(self, z: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        x = z.float()
        for layer in self.dense:
            x = self.act(layer(x))
        x = x.reshape(-1, *spec.bottleneck_hw, spec.bottleneck_c).permute(0, 3, 1, 2)
        last = len(spec.stack) - 1
        for i, ((kind, _), layer) in enumerate(zip(spec.stack, self.layers)):
            if kind == "convt":
                x = conv_transpose(layer, x)
            else:
                if kind == "upconv":
                    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
                x = conv(layer, x)
            if i < last:
                x = self.act(group_norm(self.norms[str(i)] if str(i) in self.norms else None, x))
        return x.permute(0, 2, 3, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        with exact_f32():
            return self._forward(z)


class ConvVAE(nn.Module):
    """Encoder, reparameterisation, decoder: everything the training loss
    needs. ``decoder_spec`` swaps the native decoder for an ingested one,
    whose output must be [T, M, 1] of the encoder's input."""

    def __init__(self, cfg: VAEConfig, decoder_spec: Optional[DecoderSpec] = None):
        super().__init__()
        self.cfg = cfg
        self.decoder_spec = decoder_spec
        self.encoder = ConvVAEEncoder(cfg)
        if decoder_spec is not None:
            if decoder_spec.out_hw != tuple(cfg.input_hw):
                raise ValueError(
                    f"decoder_spec reconstructs {decoder_spec.out_hw}, encoder consumes {tuple(cfg.input_hw)}"
                )
            if decoder_spec.latent_dim != cfg.latent_dim:
                raise ValueError(
                    f"decoder_spec.latent_dim={decoder_spec.latent_dim} != cfg.latent_dim={cfg.latent_dim}"
                )
            if decoder_spec.stack[-1][1] != 1:
                # a wider output would broadcast silently into a wrong loss
                raise ValueError(
                    f"decoder_spec's output conv has {decoder_spec.stack[-1][1]} channels; "
                    "the recon target is single-channel mel"
                )
            self.decoder = IngestedDecoder(decoder_spec)
        else:
            self.decoder = ConvVAEDecoder(cfg)

    def forward(self, x: torch.Tensor, *, eps: Optional[torch.Tensor] = None) -> dict:
        """With the noise ``eps`` [B, latent_dim] (``models.train.step_noise``
        draws it from a seeded generator), z = mu + exp(0.5 logvar) * eps;
        without, z = mu."""
        enc = self.encoder(x)
        mu, logvar = enc["mu"], enc["logvar"]
        z = mu if eps is None else mu + torch.exp(0.5 * logvar) * eps
        return {"recon": self.decoder(z), "z": z, "mu": mu, "logvar": logvar}

    def encode(self, x: torch.Tensor) -> dict:
        return self.encoder(x)


def seeded_state(module: nn.Module, generator: torch.Generator) -> dict:
    """Seeded random weights for ``module.load_state_dict``: normal with std
    1/sqrt(fan_in) for convs, transposed convs and dense layers (flax's lecun
    scale), zero biases, unit GroupNorm scales; drawn in ``state_dict`` order."""
    out = {}
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            if pname == "bias":
                out[key] = torch.zeros_like(p)
            elif isinstance(m, nn.GroupNorm):
                out[key] = torch.ones_like(p)
            else:
                # ConvTranspose2d stores [in, out, kH, kW]
                fan_in = p.shape[0] * math.prod(p.shape[2:]) if isinstance(m, nn.ConvTranspose2d) \
                    else math.prod(p.shape[1:])
                out[key] = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
    return out


def init_encoder_params(cfg: VAEConfig, generator: torch.Generator) -> dict:
    """Seeded random weights for ``ConvVAEEncoder(cfg).load_state_dict``."""
    return seeded_state(ConvVAEEncoder(cfg), generator)


def init_vae(cfg: VAEConfig, seed: int = 0, decoder_spec: Optional[DecoderSpec] = None):
    """-> (``ConvVAE`` with seeded weights, its ``state_dict``)."""
    vae = ConvVAE(cfg, decoder_spec)
    vae.load_state_dict(seeded_state(vae, torch.Generator().manual_seed(seed)))
    return vae, vae.state_dict()


def encoder_params_from_vae(vae_state: dict) -> dict:
    """The encoder's ``state_dict`` out of a full ``ConvVAE`` one (for serving)."""
    return {k[len("encoder."):]: v for k, v in vae_state.items() if k.startswith("encoder.")}
