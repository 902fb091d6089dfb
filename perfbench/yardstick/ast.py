"""Least work and least bytes of the Audio Spectrogram Transformer encoder
(``perfbench/reference/ast.py``), counted from its shapes.

``encoder_macs``: the patch embedding (each patch's ``patch²`` values times
``hidden``), then a block's QKV, Q Kᵀ and P V over every head, the output
projection and the two MLP layers, over all ``tokens`` (the patches and the
two class tokens). LayerNorm, GELU, softmax and the additions are left out,
as element-wise work. At the published shape (128 mels x 501 frames, 12 x 49
patches, 590 tokens, ViT-B) that is 56 643 231 744 MAC a chunk.

The attention core (what ``scaled_dot_product_attention`` computes) a chunk:
``attention_flops`` = 4 · N² · head_dim · heads · layers (Q Kᵀ and P V, 2
FLOP a MAC), ``attention_bytes`` = Q, K and V read once and O written once,
bf16, every layer.
"""

from __future__ import annotations

from perfbench.reference.ast import grid


def tokens(cfg: dict) -> int:
    f, t = grid(cfg)
    return f * t + 2


def encoder_macs(cfg: dict) -> int:
    f, t = grid(cfg)
    n, d, m = tokens(cfg), cfg["hidden"], cfg["mlp"]
    block = n * d * 3 * d + 2 * n * n * d + n * d * d + 2 * n * d * m
    return f * t * cfg["patch"] ** 2 * d + cfg["layers"] * block


def attention_flops(cfg: dict) -> int:
    n = tokens(cfg)
    return 4 * n * n * (cfg["hidden"] // cfg["heads"]) * cfg["heads"] * cfg["layers"]


def attention_bytes(cfg: dict) -> int:
    return 4 * tokens(cfg) * cfg["hidden"] * 2 * cfg["layers"]
