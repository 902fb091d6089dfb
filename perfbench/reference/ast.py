"""Plain Audio Spectrogram Transformer encoder (Gong, Chung and Glass,
Interspeech 2021; github.com/YuanGongND/ast ``src/models/ast_models.py``): PyTorch
tensor operations, float32, TF32 off, no fused attention, read from a flat
dict of named tensors (timm's ViT names, which the port's ``state_dict``
uses).

The [B, T, M] log-mel is turned frequency first ([B, 1, M, T]) and cut into
16x16 patches at stride (``fstride``, ``tstride``), flattened frequency-major
and embedded by one matrix product; the class and distillation tokens go
first and the position embeddings are added. Each block: h += Attn(LN1(h)),
h += MLP(LN2(h)); attention is softmax(Q Kᵀ / sqrt(64)) V over the heads,
written out; the MLP is W2 GELU(W1 x + b1) + b2 with the exact GELU. After
the final LayerNorm the embedding is (h[:, 0] + h[:, 1]) / 2, the input of
AST's ``mlp_head``, which is left out (the detector takes its place).

``rounding`` (a control) rounds both operands of every product before it
runs: the patch embedding, QKV, Q Kᵀ, P V, the output projection and both
MLP layers; sums stay float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from perfbench.reference.encoder import no_tf32

Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _r(x: torch.Tensor, rounding: Rounding) -> torch.Tensor:
    return x if rounding is None else rounding(x)


def grid(cfg: dict):
    """(frequency, time) patches of the configuration's input."""
    t, m = cfg["input_hw"]
    return (m - cfg["patch"]) // cfg["fstride"] + 1, (t - cfg["patch"]) // cfg["tstride"] + 1


def linear(x, w, b, rounding: Rounding):
    return _r(x, rounding) @ _r(w, rounding).t() + b


def layer_norm(x, w, b, eps: float):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def patches(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[B, T, M] -> [B, f * t, patch²]: the patches of the frequency-first plane,
    frequency-major, each read row by row as the convolution's kernel is."""
    k = cfg["patch"]
    plane = x.transpose(1, 2)  # [B, M, T]
    p = plane.unfold(1, k, cfg["fstride"]).unfold(2, k, cfg["tstride"])  # [B, f, t, k, k]
    return p.reshape(x.shape[0], -1, k * k)


def encode(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, rounding: Rounding = None) -> torch.Tensor:
    """[B, T, M] standardised log-mel -> the embedding [B, hidden], float32."""
    D, H, eps = cfg["hidden"], cfg["heads"], cfg["layer_norm_eps"]
    hd = D // H
    with no_tf32():
        B = x.shape[0]
        w = p["patch_embed.proj.weight"].reshape(D, -1)
        h = linear(patches(x.float(), cfg), w, p["patch_embed.proj.bias"], rounding)
        h = torch.cat([p["cls_token"].expand(B, -1, -1), p["dist_token"].expand(B, -1, -1), h], 1) + p["pos_embed"]
        N = h.shape[1]
        for i in range(cfg["layers"]):
            q = f"blocks.{i}."
            y = layer_norm(h, p[q + "norm1.weight"], p[q + "norm1.bias"], eps)
            qkv = linear(y, p[q + "attn.qkv.weight"], p[q + "attn.qkv.bias"], rounding)
            qh, kh, vh = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
            s = (_r(qh, rounding) @ _r(kh, rounding).transpose(-1, -2)) / math.sqrt(hd)
            a = torch.softmax(s, dim=-1)
            o = (_r(a, rounding) @ _r(vh, rounding)).transpose(1, 2).reshape(B, N, D)
            h = h + linear(o, p[q + "attn.proj.weight"], p[q + "attn.proj.bias"], rounding)
            y = layer_norm(h, p[q + "norm2.weight"], p[q + "norm2.bias"], eps)
            y = F.gelu(linear(y, p[q + "mlp.fc1.weight"], p[q + "mlp.fc1.bias"], rounding))
            h = h + linear(y, p[q + "mlp.fc2.weight"], p[q + "mlp.fc2.bias"], rounding)
        h = layer_norm(h, p["norm.weight"], p["norm.bias"], eps)
    return (h[:, 0] + h[:, 1]) / 2


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    D, M, k = cfg["hidden"], cfg["mlp"], cfg["patch"]
    f, t = grid(cfg)
    out = {"cls_token": (1, 1, D), "dist_token": (1, 1, D), "pos_embed": (1, f * t + 2, D),
           "patch_embed.proj.weight": (D, 1, k, k), "patch_embed.proj.bias": (D,)}
    for i in range(cfg["layers"]):
        q = f"blocks.{i}."
        out.update({q + "norm1.weight": (D,), q + "norm1.bias": (D,), q + "attn.qkv.weight": (3 * D, D),
                    q + "attn.qkv.bias": (3 * D,), q + "attn.proj.weight": (D, D), q + "attn.proj.bias": (D,),
                    q + "norm2.weight": (D,), q + "norm2.bias": (D,),
                    q + "mlp.fc1.weight": (M, D), q + "mlp.fc1.bias": (M,),
                    q + "mlp.fc2.weight": (D, M), q + "mlp.fc2.bias": (D,)})
    out.update({"norm.weight": (D,), "norm.bias": (D,)})
    return out


def make_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights from ``seed`` on ``device`` in one draw of a ``torch.Generator``
    there: matrices and the patch embedding normal at 1/sqrt(fan in), as the
    conv family's; the tokens and the position embeddings at 0.02 (timm's ViT
    scale); biases at 0.02, LayerNorm scales 1 + 0.05 N(0, 1) and shifts
    0.05 N(0, 1). float32, the type they are served in. (timm's 0.02 for every
    matrix leaves attention nearly uniform, so the pooled tokens barely tell
    one window from another, and the comparison's distances shrink toward
    the rounding of a bf16 trunk.)"""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed((int(seed) * 7919 + 29) % (1 << 63))
    flat = torch.randn(total, generator=g, device=device)
    out, pos = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        v = flat[pos : pos + n].view(shape)
        pos += n
        if name == "patch_embed.proj.weight":
            v = v / cfg["patch"]
        elif len(shape) == 2:
            v = v / math.sqrt(shape[1])
        elif "norm" in name:
            v = 1.0 + 0.05 * v if name.endswith("weight") else 0.05 * v
        else:
            v = 0.02 * v
        out[name] = v.contiguous()
    return out
