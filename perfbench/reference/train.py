"""Plain beta-VAE training steps: the loss (each example's mean squared
reconstruction error over the mel plane, averaged, plus beta times the mean
KL of N(mu, sigma) to N(0, I)), its gradients by autograd, and AdamW (every
tensor decayed, bias-corrected moments), with the learning rate of a linear
warm-up from 0 then a cosine decay, and beta held at 0 for a delay and then
ramped.

What a seeded run of the program draws and orders is worked out again here
from the same seed, by the rules the program documents:

- the reparameterisation noise of update k: a normal draw on the device from
  a ``torch.Generator`` seeded by ``SeedSequence([seed + 1, k])``'s first
  64-bit word (``anuraxla_torch/models/train.py`` ``step_noise``);
- the order of the training files: every species folder's WAVs sorted, the
  folders in sorted order, the list shuffled in place at the start of every
  epoch by one ``random.Random(0)`` (``anuraxla_torch/cli/train_vae.py``
  ``mel_batch_stream``).
"""

from __future__ import annotations

import math
import random
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import encoder as ref_encoder


def epoch_order(root: Path, epoch: int = 0) -> List[Path]:
    """The training files in the order of epoch ``epoch`` (0 the first)."""
    species = sorted(d for d in Path(root).iterdir() if d.is_dir() and not d.name.startswith("."))
    paths = [p for d in species for p in sorted(x for x in d.rglob("*") if x.is_file() and x.suffix in (".wav", ".WAV"))]
    rng = random.Random(0)
    for _ in range(epoch + 1):
        rng.shuffle(paths)
    return paths


def batch_paths(root: Path, batch_size: int, first: int, count: int) -> List[List[Path]]:
    """The files of updates ``first`` .. ``first + count - 1``, epochs cycled
    (the tree has to hold whole batches: no batch is padded)."""
    n = len(epoch_order(root))
    if n % batch_size:
        raise ValueError(f"{n} training files do not fill whole batches of {batch_size}")
    per_epoch, orders, out = n // batch_size, {}, []
    for step in range(first, first + count):
        e, i = divmod(step, per_epoch)
        if e not in orders:
            orders[e] = epoch_order(root, e)
        out.append(orders[e][i * batch_size : (i + 1) * batch_size])
    return out


def noise(seed: int, step: int, shape, device) -> torch.Tensor:
    key = int(np.random.SeedSequence([int(seed) + 1, step]).generate_state(1, np.uint64)[0])
    return torch.randn(shape, generator=torch.Generator(device=device).manual_seed(key), device=device)


def learning_rate(tc: dict, step: int) -> float:
    warm, peak = tc["warmup_steps"], tc["learning_rate"]
    total = max(tc["total_steps"], warm + 1)
    if step < warm:
        return peak * step / warm
    c = min(step - warm, total - warm)
    return peak * 0.5 * (1.0 + math.cos(math.pi * c / (total - warm)))


def kl_weight(tc: dict, step: int) -> float:
    warm, delay = tc["kl_warmup_steps"], tc["kl_delay_steps"]
    if warm > 0 or delay > 0:
        return tc["beta"] * min(max((step + 1.0 - delay) / max(warm, 1), 0.0), 1.0)
    return tc["beta"]


def loss_of(p: Dict[str, torch.Tensor], x: torch.Tensor, eps: torch.Tensor, cfg: dict, beta: float,
            rounding: Optional[Callable] = None) -> torch.Tensor:
    enc = ref_encoder.encode(p, x, cfg, rounding=rounding, prefix="encoder.")
    mu, logvar = enc["mu"], enc["logvar"]
    recon = ref_encoder.decode(p, mu + torch.exp(0.5 * logvar) * eps, cfg, rounding=rounding)
    err = torch.mean((recon - x) ** 2, dim=(1, 2))
    kl = 0.5 * torch.sum(torch.exp(logvar) + mu * mu - 1.0 - logvar, dim=-1)
    return err.mean() + beta * kl.mean()


def steps(p0: Dict[str, torch.Tensor], mels: List[torch.Tensor], cfg: dict, tc: dict, seed: int,
          rounding: Optional[Callable] = None, *, first: int = 0, moments=None):
    """Updates ``first`` .. ``first + len(mels) - 1`` from ``p0`` on batches
    ``mels`` ([B, T, M]); ``moments`` (AdamW's first and second moments before
    update ``first``) default to zero, as at the start.
    -> (each update's loss, the first update's gradients, the parameters after)."""
    b1, b2, eps_adam = 0.9, 0.999, 1e-8
    p = {k: v.detach().clone() for k, v in p0.items()}
    if moments is None:
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    else:
        m, v2 = ({k: t[k].detach().clone() for k in p} for t in moments)
    losses, g1 = [], None
    names = list(p)
    for k, x in enumerate(mels, start=first):
        leaves = {n: p[n].requires_grad_(True) for n in names}
        eps = noise(seed, k, (x.shape[0], cfg["latent_dim"]), x.device)
        with ref_encoder.no_tf32():
            loss = loss_of(leaves, x, eps, cfg, kl_weight(tc, k), rounding)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        losses.append(float(loss.detach()))
        if g1 is None:
            g1 = {n: g.detach().clone() for n, g in zip(names, grads)}
        lr, t = learning_rate(tc, k), k + 1
        with torch.no_grad():
            for n, g in zip(names, grads):
                q = p[n].detach()
                q.mul_(1.0 - lr * tc["weight_decay"])
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v2[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps_adam)
                q.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
                p[n] = q
    return losses, g1, p
