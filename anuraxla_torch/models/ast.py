"""Audio Spectrogram Transformer encoder (Gong, Chung and Glass, "AST: Audio
Spectrogram Transformer", Interspeech 2021; github.com/YuanGongND/ast
``src/models/ast_models.py``), served in the conv-VAE's place.

The encoder is DeiT / ViT-B as AST builds it from timm: a [1, M, T] plane
(frequency first) cut into 16x16 patches at stride ``fstride`` on frequency
and ``tstride`` on time by one convolution, the patches flattened
frequency-major, a class and a distillation token put first, learned
position embeddings added; then ``layers`` pre-LayerNorm blocks

    h += proj(softmax(Q Kᵀ / sqrt(head_dim)) V)  of LN1(h), heads of 64
    h += W2 · GELU(W1 · LN2(h) + b1) + b2          exact (erf) GELU

and the final LayerNorm. The embedding is ``(h[:, 0] + h[:, 1]) / 2``, the
input of AST's ``mlp_head``; the detector takes the head's place, so the
head (LayerNorm + the 527-way AudioSet layer) is left out and ``mu`` is the
``hidden``-wide embedding. The final LayerNorm is applied to those two
tokens alone (it acts token by token, so they read what the whole stream's
would give).

``ASTEncoder`` maps [B, T, M, 1] standardised log-mels to ``{"z", "mu"}``,
both the f32 embedding. There is no ``logvar``: AST is not variational, and
a zero one would claim a unit-variance posterior that nothing fitted; no
serving path reads it.

Precision. Parameters stay f32, as the conv trunk's do. ``dtype="bfloat16"``
runs every product (the patch convolution, QKV, the attention core, the
output projection, both MLP layers) with bf16 operands and f32 accumulation
(cuBLAS's reduced-precision split-K reduction is held off); LayerNorm
statistics and the softmax run in f32. **The residual stream is f32**: each
block reads it through an f32 LayerNorm whose output is rounded to bf16 for
the product, and adds the product's bf16 output back in f32, as
``torch.autocast`` would. ``dtype="float32"`` runs everything in f32 with
TF32 off (``utils.precision.exact_f32``).

The attention core is ``scaled_dot_product_attention`` pinned with
``sdpa_kernel`` to one backend: flash on a bf16 trunk, memory-efficient on
an f32 trunk on the card, math on an f32 trunk on the CPU. A pinned backend
that cannot run raises; nothing falls back. ``ASTEncoder.attention_calls``
counts the calls by backend.

Spans (``utils.timing``): ``patch_embed`` (rows) around the patch
embedding, ``attention`` (tokens) around each block's attention core.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from anuraxla_torch.models.vae import as_torch_dtype
from anuraxla_torch.utils.precision import exact_f32
from anuraxla_torch.utils.timing import span


@dataclasses.dataclass(frozen=True)
class ASTConfig:
    """Architecture hyperparameters (defaults: AST's ViT-B at the system's 5 s
    chunk, 128 mels x 501 frames: 12 x 49 patches, 590 tokens). ``dtype`` is
    the trunk compute dtype, as ``VAEConfig``'s. ``layer_norm_eps`` follows
    timm's DeiT, which AST builds on (Hugging Face's ``ASTConfig`` says 1e-12)."""

    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp: int = 3072
    patch: int = 16
    fstride: int = 10
    tstride: int = 10
    input_hw: tuple[int, int] = (501, 128)  # (T, M)
    layer_norm_eps: float = 1e-6
    dtype: object = "float32"

    @property
    def latent_dim(self) -> int:
        """The embedding's width: what the detector fits on."""
        return self.hidden

    @property
    def grid(self) -> tuple[int, int]:
        """(frequency, time) patches."""
        t, m = self.input_hw
        return (m - self.patch) // self.fstride + 1, (t - self.patch) // self.tstride + 1

    @property
    def tokens(self) -> int:
        f, t = self.grid
        return f * t + 2


def _backend(dtype: torch.dtype, device: torch.device) -> SDPBackend:
    if dtype == torch.bfloat16:
        return SDPBackend.FLASH_ATTENTION
    return SDPBackend.EFFICIENT_ATTENTION if device.type == "cuda" else SDPBackend.MATH


_NAMES = {SDPBackend.FLASH_ATTENTION: "flash", SDPBackend.EFFICIENT_ATTENTION: "efficient", SDPBackend.MATH: "math"}


@contextlib.contextmanager
def _f32_accumulate():
    """bf16 products accumulate in f32: cuBLAS's reduced-precision split-K
    reduction off inside the block, the flag restored after."""
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ASTConfig):
        super().__init__()
        self.proj = nn.Conv2d(1, cfg.hidden, cfg.patch, stride=(cfg.fstride, cfg.tstride))


class Attention(nn.Module):
    def __init__(self, cfg: ASTConfig):
        super().__init__()
        self.heads = cfg.heads
        self.qkv = nn.Linear(cfg.hidden, 3 * cfg.hidden)
        self.proj = nn.Linear(cfg.hidden, cfg.hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        q, k, v = _linear(self.qkv, x).view(B, N, 3, self.heads, D // self.heads).permute(2, 0, 3, 1, 4).unbind(0)
        backend = _backend(x.dtype, x.device)
        with span("attention", tokens=B * N), sdpa_kernel([backend]):
            o = F.scaled_dot_product_attention(q, k, v)
        ASTEncoder.attention_calls[_NAMES[backend]] += 1
        return _linear(self.proj, o.transpose(1, 2).reshape(B, N, D))


class Mlp(nn.Module):
    def __init__(self, cfg: ASTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden, cfg.mlp)
        self.fc2 = nn.Linear(cfg.mlp, cfg.hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(self.fc2, F.gelu(_linear(self.fc1, x)))


class Block(nn.Module):
    def __init__(self, cfg: ASTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps)
        self.attn = Attention(cfg)
        self.norm2 = nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps)
        self.mlp = Mlp(cfg)

    def forward(self, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``h``: the f32 residual stream; products in ``dtype``."""
        h = h + self.attn(self.norm1(h).to(dtype))
        return h + self.mlp(self.norm2(h).to(dtype))


class ASTEncoder(nn.Module):
    """[B, T, M, 1] log-mel -> {"z", "mu"}: the f32 embedding [B, hidden]."""

    # calls of the attention core by SDPA backend, since the process started
    attention_calls = {"flash": 0, "efficient": 0, "math": 0}

    def __init__(self, cfg: ASTConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = as_torch_dtype(cfg.dtype)
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.tokens, cfg.hidden))
        self.blocks = nn.ModuleList([Block(cfg) for _ in range(cfg.layers)])
        self.norm = nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps)

    def _forward(self, x: torch.Tensor) -> dict:
        cfg, dt, B = self.cfg, self.dtype, x.shape[0]
        if tuple(x.shape[1:3]) != tuple(cfg.input_hw):
            raise ValueError(f"AST encoder expects input {tuple(cfg.input_hw)}, got {tuple(x.shape[1:3])}")
        with span("patch_embed", rows=B):
            w = self.patch_embed.proj
            plane = x[..., 0].transpose(1, 2)[:, None].to(dt)  # [B, 1, M, T]: frequency first
            p = F.conv2d(plane, w.weight.to(dt), w.bias.to(dt), stride=w.stride)
            p = p.flatten(2).transpose(1, 2).float()  # [B, f * t, D], frequency-major
            h = torch.cat([self.cls_token.expand(B, -1, -1), self.dist_token.expand(B, -1, -1), p], 1) + self.pos_embed
        for blk in self.blocks:
            h = blk(h, dt)
        h = self.norm(h[:, :2])
        emb = (h[:, 0] + h[:, 1]) / 2
        return {"z": emb, "mu": emb}

    def forward(self, x: torch.Tensor) -> dict:
        with exact_f32(), _f32_accumulate():
            return self._forward(x)


def init_ast_params(cfg: ASTConfig, generator: torch.Generator) -> dict:
    """Seeded weights for ``ASTEncoder(cfg).load_state_dict``, timm's ViT
    init: linear weights, the tokens and the position embeddings truncated
    normal at 0.02 (cut at ±2, timm's bounds), linear biases 0, LayerNorm 1 / 0;
    the patch convolution at PyTorch's default, uniform at ±1/sqrt(fan in),
    weight and bias. Drawn in ``state_dict`` order."""
    out = {}
    for key, p in ASTEncoder(cfg).state_dict().items():
        if key.startswith("patch_embed."):
            bound = 1.0 / math.sqrt(cfg.patch * cfg.patch)
            out[key] = (torch.rand(p.shape, generator=generator) * 2 - 1) * bound
        elif ".norm" in key or key.startswith("norm."):
            out[key] = torch.ones_like(p) if key.endswith("weight") else torch.zeros_like(p)
        elif key.endswith("bias"):
            out[key] = torch.zeros_like(p)
        else:
            out[key] = nn.init.trunc_normal_(torch.empty(p.shape), std=0.02, a=-2.0, b=2.0, generator=generator)
    return out
