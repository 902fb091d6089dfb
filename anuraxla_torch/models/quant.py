"""Int8 post-training quantization of the conv VAE encoder for serving — the
port of ``anuraxla/models/quant.py``.

Symmetric int8 weights with one scale per output channel, symmetric int8
activations with one scale per layer (calibrated from a representative
batch) or, without a calibration batch, one per ROW of the batch computed in
the forward (reduced over every axis but the batch, so a row's latent never
depends on its batch-mates). The conv and dense contractions run on int8
operands with int32 sums (``ops/int8.py``: a Hopper kernel on the card, the
plain version on the CPU); GroupNorm, the activation, the avgpool and the
latent heads stay f32.

Flow:
    q = quantize_encoder(state_dict, cfg, calib_x, device=...)
    mu = encoder_apply_quantized(q, cfg, x)["mu"]

``params`` is the port's encoder ``state_dict`` or the JAX package's param
tree (numpy or tensors, with or without the outer ``"params"``). The
quantized tree is a plain dict of tensors with the JAX tree's keys:
``{"conv": {name: {"wq", "sw", "bias"}}, "act_scale": {name: s}, "gn":
{...}, "f32": {"head_mu", "head_logvar"}}``, ``wq`` in the reference's
layouts (HWIO convs, [K, N] dense). On the card each entry whose shape the
kernel's ``wgmma`` path takes also holds ``"wq_packed"``
(``ops.int8.pack_weight``, made once here); the top-level keys stay the
JAX tree's. Tensors are NHWC on an explicit device.

On the card the forward hands each conv and the dense its f32 input and
``sx``: the kernel quantizes as it loads, to the codes ``_quant_x`` gives.
On the CPU ``_quant_x`` runs first, as in the reference.

Traps the port pins (``tests/test_torch_quant.py`` holds it to the JAX
package): rounding is half to even (``torch.round``; the kernel's epilogue
rounds nothing to an integer); the scales multiply first, ``y * (sx * sw) +
bias``; GroupNorm is the reference's own mean / var form, not
``nn.GroupNorm``, so both packages compute one function; the stride-2 pads
are XLA's SAME, or (1, 1) for ``conv_padding="TORCH"``.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from anuraxla_torch import resolve_device
from anuraxla_torch.models.convert import encoder_params_for_jax
from anuraxla_torch.models.vae import VAEConfig, activation, same_pads
from anuraxla_torch.ops.int8 import int8_conv, int8_dense, pack_weight, patches as _patches, wgmma_tile
from anuraxla_torch.utils.precision import exact_f32


def _conv_pads(cfg: VAEConfig, h: int, w: int, stride: int):
    if stride == 1 or cfg.conv_padding == "TORCH":
        return (1, 1), (1, 1)  # k3 SAME at stride 1 == torch padding=1
    return same_pads(h, stride), same_pads(w, stride)


def _group_norm(x, scale, bias, groups: int, eps: float):
    """The reference's GroupNorm: mean, then the mean of squared deviations,
    both summed in float64 and rounded to f32 once, so a statistic does not
    depend on the order a device sums in (nor on the batch's other rows)."""
    b, h, w, c = x.shape
    g = min(groups, c)
    xg = x.reshape(b, h, w, g, c // g)
    n = h * w * (c // g)
    mean = (xg.sum(dim=(1, 2, 4), keepdim=True, dtype=torch.float64) / n).float()
    d = xg - mean
    var = ((d * d).sum(dim=(1, 2, 4), keepdim=True, dtype=torch.float64) / n).float()
    xn = (d / torch.sqrt(var + eps)).reshape(b, h, w, c)
    return xn * scale + bias


def _conv_f32(x, kernel, bias, stride: int, pads):
    p = _patches(x, stride, pads)
    y = p.reshape(-1, p.shape[-1]) @ kernel.reshape(-1, kernel.shape[-1]) + bias
    return y.reshape(*p.shape[:3], -1)


def _avg_pool2(x):
    """AvgPool2d(2) VALID: floor halving, the odd row or column dropped; a
    fixed linear op the int8 path runs in f32 after the activation."""
    b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    return x[:, : h2 * 2, : w2 * 2, :].reshape(b, h2, 2, w2, 2, c).mean(dim=(2, 4))


def _block_convs(cfg: VAEConfig):
    """(conv index, stride) of each conv of a block: stride family (Conv_0 s2,
    Conv_1 s1); avgpool family one s1 Conv_0, then the pool."""
    if cfg.downsample == "avgpool":
        return ((0, 1),)
    return ((0, 2), (1, 1))


def _tensor(a, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    return t.detach().to(device=device, dtype=torch.float32)


def _tree(params, cfg: VAEConfig, device) -> dict:
    """The JAX package's tree ({"params": ...}) of f32 tensors on ``device``,
    from the port's encoder ``state_dict`` or a JAX-layout tree; returned as
    it is when it already is one."""
    if "dense.weight" in params:
        params = encoder_params_for_jax(params, cfg)
    p = params.get("params", params)
    leaf = p["Dense_0"]["kernel"]
    if isinstance(leaf, torch.Tensor) and leaf.device == torch.device(device) and leaf.dtype == torch.float32:
        return {"params": p}

    def walk(node):
        return {k: walk(v) for k, v in node.items()} if isinstance(node, Mapping) else _tensor(node, device)

    return {"params": walk(p)}


def encoder_forward_f32(params, cfg: VAEConfig, x: torch.Tensor, *, collect: Optional[dict] = None):
    """The deterministic encoder (``ConvVAEEncoder``'s ``mu``), written out as
    the reference's twin: im2col convs, its GroupNorm. With ``collect`` (a
    dict), records each quantizable layer's input absmax under its name —
    the activation-scale calibration pass. ``x`` [B, T, M, 1] on its device."""
    p = _tree(params, cfg, x.device)["params"]
    act = activation(cfg.activation)

    def note(name, v):
        if collect is not None:
            m = v.abs().max()
            collect[name] = torch.maximum(collect[name], m) if name in collect else m

    with exact_f32():
        for i in range(len(cfg.widths)):
            blk = p[f"EncoderBlock_{i}"]
            for j, stride in _block_convs(cfg):
                pads = _conv_pads(cfg, x.shape[1], x.shape[2], stride)
                note(f"EncoderBlock_{i}/Conv_{j}", x)
                x = _conv_f32(x, blk[f"Conv_{j}"]["kernel"], blk[f"Conv_{j}"]["bias"], stride, pads)
                if cfg.norm == "group":
                    gn = blk[f"GroupNorm_{j}"]
                    x = _group_norm(x, gn["scale"], gn["bias"], cfg.groups, cfg.gn_eps)
                x = act(x)
            if cfg.downsample == "avgpool":
                x = _avg_pool2(x)
        x = x.reshape(x.shape[0], -1)
        note("Dense_0", x)
        x = act(x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"])
        return x @ p["head_mu"]["kernel"] + p["head_mu"]["bias"]


def _entry(wq: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor) -> dict:
    """A contraction's entry of the tree; on the card with the packed W of
    the kernel's wgmma path where the shape takes it."""
    e = {"wq": wq, "sw": sw, "bias": bias}
    if wq.device.type == "cuda" and wgmma_tile(wq.numel() // wq.shape[-1], wq.shape[-1], dense=wq.ndim == 2):
        e["wq_packed"] = pack_weight(wq)
    return e


def _quant_weight(w: torch.Tensor):
    """Symmetric per-output-channel int8: w ~= wq * sw."""
    amax = w.abs().amax(dim=tuple(range(w.ndim - 1)))
    sw = torch.clamp_min(amax / 127.0, 1e-12)
    wq = torch.clamp(torch.round(w / sw), -127, 127).to(torch.int8)
    return wq, sw.to(torch.float32)


def quantize_encoder(params, cfg: VAEConfig, calib_x: Optional[torch.Tensor] = None, *, device=None) -> dict:
    """Weight quantization (and, with ``calib_x`` — a representative
    [B, T, M, 1] log-mel batch — one activation scale a layer from its absmax)
    -> the serving tree on ``device`` (default: ``calib_x``'s, else the card).
    Without ``calib_x`` no activation scales are stored and
    :func:`encoder_apply_quantized` takes them per row in the forward."""
    device = resolve_device(device if device is not None else
                            (calib_x.device if calib_x is not None else "cuda"))
    tree = _tree(params, cfg, device)
    collect: dict = {}
    if calib_x is not None:
        encoder_forward_f32(tree, cfg, calib_x.to(device), collect=collect)
    p = tree["params"]
    q: dict = {"conv": {}, "act_scale": {}, "gn": {}, "f32": {}}
    for i in range(len(cfg.widths)):
        blk = p[f"EncoderBlock_{i}"]
        for j, _ in _block_convs(cfg):
            name = f"EncoderBlock_{i}/Conv_{j}"
            wq, sw = _quant_weight(blk[f"Conv_{j}"]["kernel"])
            q["conv"][name] = _entry(wq, sw, blk[f"Conv_{j}"]["bias"])
            if calib_x is not None:
                q["act_scale"][name] = torch.clamp_min(collect[name] / 127.0, 1e-12)
            if cfg.norm == "group":
                q["gn"][f"EncoderBlock_{i}/GroupNorm_{j}"] = {
                    "scale": blk[f"GroupNorm_{j}"]["scale"], "bias": blk[f"GroupNorm_{j}"]["bias"],
                }
    wq, sw = _quant_weight(p["Dense_0"]["kernel"])
    q["conv"]["Dense_0"] = _entry(wq, sw, p["Dense_0"]["bias"])
    if calib_x is not None:
        q["act_scale"]["Dense_0"] = torch.clamp_min(collect["Dense_0"] / 127.0, 1e-12)
    q["f32"]["head_mu"] = p["head_mu"]
    q["f32"]["head_logvar"] = p["head_logvar"]
    return q


def _quant_x(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)


def _act_scale(q: dict, name: str, v: torch.Tensor) -> torch.Tensor:
    """The stored calibration scale, else one a row: absmax over every axis
    but the batch, as [B, 1, ...]."""
    s = q["act_scale"].get(name)
    if s is not None:
        return s
    return torch.clamp_min(v.abs().amax(dim=tuple(range(1, v.ndim)), keepdim=True) / 127.0, 1e-12)


def encoder_apply_quantized(q: dict, cfg: VAEConfig, x: torch.Tensor) -> dict:
    """[B, T, M, 1] log-mel -> {"z", "mu"} (z == mu, the deterministic
    serving contract) with int8 conv / dense contractions; ``q`` and ``x`` on
    one device. On the card the kernels quantize the f32 activations as they
    load them; on the CPU ``_quant_x`` runs first."""
    act = activation(cfg.activation)
    on_card = x.device.type == "cuda"

    def operand(v, sx):
        return v if on_card else _quant_x(v, sx)

    with exact_f32():
        for i in range(len(cfg.widths)):
            for j, stride in _block_convs(cfg):
                name = f"EncoderBlock_{i}/Conv_{j}"
                c = q["conv"][name]
                sx = _act_scale(q, name, x)
                pads = _conv_pads(cfg, x.shape[1], x.shape[2], stride)
                x = int8_conv(operand(x, sx), c["wq"], sx, c["sw"], c["bias"], stride, pads,
                              packed=c.get("wq_packed"))
                if cfg.norm == "group":
                    gn = q["gn"][f"EncoderBlock_{i}/GroupNorm_{j}"]
                    x = _group_norm(x, gn["scale"], gn["bias"], cfg.groups, cfg.gn_eps)
                x = act(x)
            if cfg.downsample == "avgpool":
                x = _avg_pool2(x)
        x = x.reshape(x.shape[0], -1)
        c = q["conv"]["Dense_0"]
        sx = _act_scale(q, "Dense_0", x)
        x = act(int8_dense(operand(x, sx), c["wq"], sx, c["sw"], c["bias"], packed=c.get("wq_packed")))
        mu = x @ q["f32"]["head_mu"]["kernel"] + q["f32"]["head_mu"]["bias"]
    return {"z": mu, "mu": mu}
