"""Plain conv-VAE encoder and decoder (PyTorch functional ops, float32, TF32
off), read from a flat dict of named tensors.

Encoder: blocks of a stride-2 3x3 convolution (padded as XLA's SAME, or
one row and column each side for ``conv_padding="TORCH"``) and a stride-1 3x3
convolution (``downsample="stride"``), or one stride-1 3x3
convolution and a 2x2 average pool (``"avgpool"``); each convolution followed
by GroupNorm and the activation. Then the NHWC flatten, a dense layer with the
activation, and the ``mu`` / ``logvar`` heads. Decoder: dense, dense, a
reshape to the bottleneck, blocks of a 4x4 stride-2 transposed convolution
and a 3x3 convolution (each with GroupNorm and SiLU), a last transposed
convolution with SiLU and a 3x3 output convolution.

``rounding`` (a control) rounds both operands of every convolution and dense
layer before it runs; sums stay float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]


@contextlib.contextmanager
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _r(x: torch.Tensor, rounding: Rounding) -> torch.Tensor:
    return x if rounding is None else rounding(x)


def same_pads(n: int, stride: int, k: int = 3):
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv(x, w, b, stride, rounding: Rounding, padding: str = "SAME"):
    if stride == 2:
        if padding == "TORCH":
            (t0, t1), (l0, l1) = (1, 1), (1, 1)
        else:
            (t0, t1), (l0, l1) = same_pads(x.shape[2], 2), same_pads(x.shape[3], 2)
        x = F.pad(x, (l0, l1, t0, t1))
        return F.conv2d(_r(x, rounding), _r(w, rounding), b, stride=2)
    return F.conv2d(_r(x, rounding), _r(w, rounding), b, stride=1, padding=1)


def linear(x, w, b, rounding: Rounding):
    return F.linear(_r(x, rounding), _r(w, rounding), b)


def act(name: str):
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    return getattr(F, name)


def groups(cfg: dict, width: int) -> int:
    return min(cfg["groups"], width)


def encode(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, rounding: Rounding = None,
           prefix: str = "") -> Dict[str, torch.Tensor]:
    """[B, T, M] standardised log-mel -> {"mu", "logvar"} [B, latent_dim]."""
    f = act(cfg["activation"])
    with no_tf32():
        h = x[:, None].float()
        for i, w in enumerate(cfg["widths"]):
            q = f"{prefix}blocks.{i}."
            g = groups(cfg, w)
            if cfg["downsample"] == "avgpool":
                h = conv(h, p[q + "conv1.weight"], p[q + "conv1.bias"], 1, rounding)
                h = f(F.group_norm(h, g, p[q + "gn1.weight"], p[q + "gn1.bias"], cfg["gn_eps"]))
                h = F.avg_pool2d(h, 2)
            else:
                h = conv(h, p[q + "conv1.weight"], p[q + "conv1.bias"], 2, rounding, cfg["conv_padding"])
                h = f(F.group_norm(h, g, p[q + "gn1.weight"], p[q + "gn1.bias"], cfg["gn_eps"]))
                h = conv(h, p[q + "conv2.weight"], p[q + "conv2.bias"], 1, rounding)
                h = f(F.group_norm(h, g, p[q + "gn2.weight"], p[q + "gn2.bias"], cfg["gn_eps"]))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        h = f(linear(h, p[prefix + "dense.weight"], p[prefix + "dense.bias"], rounding))
        mu = linear(h, p[prefix + "head_mu.weight"], p[prefix + "head_mu.bias"], rounding)
        logvar = linear(h, p[prefix + "head_logvar.weight"], p[prefix + "head_logvar.bias"], rounding)
    return {"mu": mu, "logvar": logvar}


def bottleneck(cfg: dict):
    t, m = cfg["input_hw"]
    for _ in cfg["widths"]:
        t, m = (t // 2, m // 2) if cfg["downsample"] == "avgpool" else (-(-t // 2), -(-m // 2))
    return t, m


def decode(p: Dict[str, torch.Tensor], z: torch.Tensor, cfg: dict, rounding: Rounding = None,
           prefix: str = "decoder.") -> torch.Tensor:
    """[B, latent_dim] -> [B, T', M'] reconstruction."""
    bt, bm = bottleneck(cfg)
    w0 = cfg["widths"][-1]
    eps = cfg["decoder_gn_eps"]

    def convt(h, name):
        return F.conv_transpose2d(_r(h, rounding), _r(p[name + ".weight"], rounding), p[name + ".bias"],
                                  stride=2, padding=1)

    with no_tf32():
        h = F.silu(linear(z, p[prefix + "dense0.weight"], p[prefix + "dense0.bias"], rounding))
        h = F.silu(linear(h, p[prefix + "dense1.weight"], p[prefix + "dense1.bias"], rounding))
        h = h.reshape(-1, bt, bm, w0).permute(0, 3, 1, 2)
        for i, w in enumerate(reversed(cfg["widths"][:-1])):
            q = f"{prefix}blocks.{i}."
            g = groups(cfg, w)
            h = F.silu(F.group_norm(convt(h, q + "convt"), g, p[q + "gn1.weight"], p[q + "gn1.bias"], eps))
            h = conv(h, p[q + "conv.weight"], p[q + "conv.bias"], 1, rounding)
            h = F.silu(F.group_norm(h, g, p[q + "gn2.weight"], p[q + "gn2.bias"], eps))
        h = F.silu(convt(h, prefix + "convt"))
        return conv(h, p[prefix + "out.weight"], p[prefix + "out.bias"], 1, rounding)[:, 0]


def param_shapes(cfg: dict, *, decoder: bool = False) -> Dict[str, tuple]:
    """Name -> shape of every tensor of the encoder (and, with ``decoder``,
    of the whole VAE: encoder names under ``encoder.``)."""
    out: Dict[str, tuple] = {}
    pre = "encoder." if decoder else ""
    cin = 1
    for i, w in enumerate(cfg["widths"]):
        q = f"{pre}blocks.{i}."
        convs = ("conv1",) if cfg["downsample"] == "avgpool" else ("conv1", "conv2")
        for j, c in enumerate(convs):
            out[q + c + ".weight"] = (w, cin if j == 0 else w, 3, 3)
            out[q + c + ".bias"] = (w,)
            out[q + f"gn{j + 1}.weight"] = (w,)
            out[q + f"gn{j + 1}.bias"] = (w,)
        cin = w
    bt, bm = bottleneck(cfg)
    out[pre + "dense.weight"] = (cfg["dense_width"], bt * bm * cin)
    out[pre + "dense.bias"] = (cfg["dense_width"],)
    for h in ("head_mu", "head_logvar"):
        out[f"{pre}{h}.weight"] = (cfg["latent_dim"], cfg["dense_width"])
        out[f"{pre}{h}.bias"] = (cfg["latent_dim"],)
    if decoder:
        d = "decoder."
        w0 = cfg["widths"][-1]
        out[d + "dense0.weight"] = (cfg["dense_width"], cfg["latent_dim"])
        out[d + "dense0.bias"] = (cfg["dense_width"],)
        out[d + "dense1.weight"] = (bt * bm * w0, cfg["dense_width"])
        out[d + "dense1.bias"] = (bt * bm * w0,)
        chans = [w0] + list(reversed(cfg["widths"][:-1]))
        for i in range(len(chans) - 1):
            q = f"{d}blocks.{i}."
            out[q + "convt.weight"] = (chans[i], chans[i + 1], 4, 4)
            out[q + "convt.bias"] = (chans[i + 1],)
            out[q + "conv.weight"] = (chans[i + 1], chans[i + 1], 3, 3)
            out[q + "conv.bias"] = (chans[i + 1],)
            for n in ("gn1", "gn2"):
                out[q + n + ".weight"] = (chans[i + 1],)
                out[q + n + ".bias"] = (chans[i + 1],)
        out[d + "convt.weight"] = (chans[-1], 16, 4, 4)
        out[d + "convt.bias"] = (16,)
        out[d + "out.weight"] = (1, 16, 3, 3)
        out[d + "out.bias"] = (1,)
    return out


def make_params(cfg: dict, seed: int, device, *, decoder: bool = False) -> Dict[str, torch.Tensor]:
    """Weights from ``seed`` on ``device`` in one draw of a ``torch.Generator``
    there: weights normal at 1/sqrt(fan in), biases at 0.05, GroupNorm scales
    1 + 0.05 N(0, 1) and shifts 0.05 N(0, 1). float32, the type they are
    served and trained in."""
    shapes = param_shapes(cfg, decoder=decoder)
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed((int(seed) * 7919 + 17) % (1 << 63))
    flat = torch.randn(total, generator=g, device=device)
    out, pos = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        v = flat[pos : pos + n].view(shape)
        pos += n
        if len(shape) > 1:
            fan_in = shape[0] * math.prod(shape[2:]) if name.endswith("convt.weight") else math.prod(shape[1:])
            v = v / math.sqrt(fan_in)
        elif ".gn" in name and name.endswith(".weight"):
            v = 1.0 + 0.05 * v
        else:
            v = 0.05 * v
        out[name] = v.contiguous()
    return out
