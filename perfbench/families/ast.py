"""The Audio Spectrogram Transformer encoder (``anuraxla_torch/models/ast.py``
``ASTEncoder``): ViT-B over 16x16 patches of the log-mel at stride 10, a
class and a distillation token, pre-LayerNorm blocks, the two tokens' mean
as the embedding. Its reference is ``perfbench/reference/ast.py``, its least
work ``perfbench/yardstick/ast.py``.

A program without the AST encoder cannot run a configuration of this
family: loading the family then exits at once, naming what is missing,
before any input is written.
"""

from __future__ import annotations

import importlib.util

from perfbench.reference import ast as ref_ast
from perfbench.yardstick import ast as yardstick

PORT_MODULE = "anuraxla_torch.models.ast"

if importlib.util.find_spec(PORT_MODULE) is None:
    raise SystemExit(f"the program has no AST encoder ({PORT_MODULE}): it cannot run the 'ast' family")


def program_config(cfg: dict):
    from anuraxla_torch.models.ast import ASTConfig

    c = cfg
    return ASTConfig(hidden=c["hidden"], layers=c["layers"], heads=c["heads"], mlp=c["mlp"], patch=c["patch"],
                     fstride=c["fstride"], tstride=c["tstride"], input_hw=tuple(c["input_hw"]),
                     layer_norm_eps=c["layer_norm_eps"])


def make_params(cfg: dict, seed: int, device):
    return ref_ast.make_params(cfg, seed, device)


def encode(params, mels, cfg: dict, rounding=None):
    return ref_ast.encode(params, mels, cfg, rounding=rounding)


def latent_dim(cfg: dict) -> int:
    return cfg["hidden"]


def encoder_macs(cfg: dict) -> int:
    return yardstick.encoder_macs(cfg)


def cpu_cut(cfg: dict) -> dict:
    """Two blocks of width 128 (two heads of 64, MLP 512): the published
    ViT-B's 113 GFLOP a chunk takes seconds a window on the CPU. The patch
    geometry, the head size and the 590 tokens are kept."""
    return dict(cfg, layers=2, hidden=128, heads=2, mlp=512)
