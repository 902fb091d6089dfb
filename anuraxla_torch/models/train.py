"""β-VAE training — the port of ``anuraxla/models/train.py``: the objective on
log-mel batches, AdamW under optax's warmup-cosine schedule, the KL delay and
ramp, and the single-device loop.

What carries over exactly, and what cannot:
- ``make_optimizer`` is ``torch.optim.AdamW`` with every parameter in one
  group: optax's ``adamw`` decays every leaf (biases, GroupNorm scales,
  heads), and its update ``lr·(m̂/(√v̂+ε) + wd·p)`` is AdamW's. The learning
  rate of update k is ``warmup_cosine_decay_schedule(...)(k)``, optax's
  schedule, which starts at 0: one update with ``warmup_steps > 0`` moves
  nothing.
- The reparameterisation noise of update k comes from a generator seeded by
  (seed, k) (``step_noise``), so a resumed run draws what an uninterrupted
  one would. It is not JAX's ``fold_in(PRNGKey(seed + 1), k)``: a test that
  holds the two packages together passes JAX's noise in as ``eps``.
- Every f32 step runs with TF32 off across the forward, the backward and the
  optimizer (``utils.precision.exact_f32``): cuDNN's default would make the
  card's f32 gradients TF32 ones. A bf16 trunk (``VAEConfig.dtype``) keeps
  the parameters f32, as the JAX package does.
- The train state is the model, its optimizer and the number of updates
  taken, the count both the schedule and β read; the module updates it in
  place (JAX's is immutable).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Optional

import numpy as np
import torch

from anuraxla_torch import resolve_device
from anuraxla_torch.models.vae import ConvVAE, DecoderSpec, VAEConfig, init_vae
from anuraxla_torch.utils.metrics import log_metrics
from anuraxla_torch.utils.precision import exact_f32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    beta: float = 1.0  # KL weight (after delay + ramp)
    # beta_t = beta * clip((step+1 - kl_delay_steps) / kl_warmup_steps, 0, 1):
    # a hard zero for the first kl_delay_steps, then a linear ramp (why the
    # delay matters: anuraxla/models/train.py:26-35)
    kl_delay_steps: int = 200
    kl_warmup_steps: int = 500
    warmup_steps: int = 200  # LR warmup
    total_steps: int = 10_000
    batch_size: int = 64
    seed: int = 0


@dataclasses.dataclass
class TrainState:
    model: ConvVAE
    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    step: int = 0  # updates taken: the schedule's and β's count


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, sigma) || N(0, I)) per example."""
    return 0.5 * torch.sum(torch.exp(logvar) + mu * mu - 1.0 - logvar, dim=-1)


def vae_loss(vae: ConvVAE, batch: torch.Tensor, eps: Optional[torch.Tensor], beta: float):
    """-> (loss, {"loss", "recon", "kl"}): the per-example MSE over (T, M, C),
    its mean, plus β times the mean KL."""
    out = vae(batch, eps=eps)
    recon_err = torch.mean((out["recon"] - batch) ** 2, dim=(1, 2, 3))
    kl = kl_divergence(out["mu"], out["logvar"])
    loss = recon_err.mean() + beta * kl.mean()
    return loss, {"loss": loss.detach(), "recon": recon_err.mean().detach(), "kl": kl.mean().detach()}


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable[[int], float]:
    """optax's schedule of that name: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine to ``end_value`` at
    ``decay_steps``, held after."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / span)) if span > 0 else 1.0
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def make_schedule(tc: TrainConfig) -> Callable[[int], float]:
    return warmup_cosine_decay_schedule(0.0, tc.learning_rate, tc.warmup_steps,
                                        max(tc.total_steps, tc.warmup_steps + 1))


def make_optimizer(tc: TrainConfig, parameters) -> torch.optim.AdamW:
    """optax's ``adamw`` defaults (b1 0.9, b2 0.999, eps 1e-8), every
    parameter decayed; the train step sets the learning rate each update."""
    return torch.optim.AdamW(parameters, lr=tc.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=tc.weight_decay)


def kl_beta(beta: float, step: int, kl_warmup_steps: int = 0, kl_delay_steps: int = 0) -> float:
    """β of update ``step`` (``anuraxla/models/train.py:117-125``)."""
    if kl_warmup_steps > 0 or kl_delay_steps > 0:
        return beta * min(max((step + 1.0 - kl_delay_steps) / max(kl_warmup_steps, 1), 0.0), 1.0)
    return beta


def step_noise(seed: int, step: int, shape, device) -> torch.Tensor:
    """The reparameterisation noise of update ``step``, from a generator on
    ``device`` seeded by (seed, step)."""
    key = int(np.random.SeedSequence([seed + 1, step]).generate_state(1, np.uint64)[0])
    return torch.randn(shape, generator=torch.Generator(device=device).manual_seed(key), device=device)


def create_train_state(cfg: VAEConfig, tc: TrainConfig, *, decoder_spec: Optional[DecoderSpec] = None,
                       init_params: Optional[dict] = None, device="cuda"):
    """-> (vae, TrainState) on ``device``: seeded weights (``tc.seed``), or
    ``init_params`` (a ``ConvVAE`` ``state_dict``, e.g. an encoder artifact's
    weights beside a decoder: train-vae --init-from) after a check that it
    names the architecture's tensors at their shapes."""
    dev = resolve_device(device)
    vae, params = init_vae(cfg, seed=tc.seed, decoder_spec=decoder_spec)
    if init_params is not None:
        want = {k: tuple(v.shape) for k, v in params.items()}
        got = {k: tuple(v.shape) for k, v in init_params.items()}
        if want != got:
            diff = sorted(set(want.items()) ^ set(got.items()))
            raise ValueError(f"init_params structure does not match the architecture: {diff[:6]}")
        vae.load_state_dict(init_params)
    vae.to(dev)
    return vae, TrainState(vae, make_optimizer(tc, vae.parameters()), make_schedule(tc))


def make_train_step(beta: float, kl_warmup_steps: int = 0, kl_delay_steps: int = 0, *, seed: int = 0):
    """-> step(state, batch, eps=None) -> (state, metrics): one AdamW update
    of ``state`` in place. ``batch`` is [B, T, M, 1] on the model's device;
    ``eps`` [B, latent_dim] defaults to ``step_noise(seed, state.step)``.
    The metrics stay on the device (reading them waits for it)."""

    def step(state: TrainState, batch: torch.Tensor, eps: Optional[torch.Tensor] = None):
        model, opt = state.model, state.optimizer
        if eps is None:
            eps = step_noise(seed, state.step, (batch.shape[0], model.cfg.latent_dim), batch.device)
        with exact_f32():
            opt.zero_grad(set_to_none=True)
            loss, metrics = vae_loss(model, batch, eps, kl_beta(beta, state.step, kl_warmup_steps, kl_delay_steps))
            loss.backward()
            for group in opt.param_groups:
                group["lr"] = state.schedule(state.step)
            opt.step()
        state.step += 1
        return state, metrics

    return step


def train_loop(cfg: VAEConfig, tc: TrainConfig, batch_iter, *, num_steps: Optional[int] = None,
               log_every: int = 50, log_fn=print, initial_state: Optional[TrainState] = None,
               decoder_spec: Optional[DecoderSpec] = None, init_params: Optional[dict] = None, device="cuda"):
    """Single-device loop over an iterator of [B, T, M, 1] batches (numpy or
    torch). ``initial_state`` resumes a restored checkpoint; ``init_params``
    warm-starts step 0; ``decoder_spec`` trains an ingested decoder. ->
    (vae, state, the last metrics as floats)."""
    if initial_state is not None:
        state = initial_state
    else:
        _, state = create_train_state(cfg, tc, decoder_spec=decoder_spec, init_params=init_params, device=device)
    dev = next(state.model.parameters()).device
    step_fn = make_train_step(tc.beta, tc.kl_warmup_steps, tc.kl_delay_steps, seed=tc.seed)
    n = num_steps if num_steps is not None else tc.total_steps
    metrics = {}
    # islice stops before drawing batch n (the reference's loop draws it and
    # drops it: one mel batch computed for nothing)
    for i, batch in enumerate(itertools.islice(batch_iter, n)):
        state, metrics = step_fn(state, torch.as_tensor(batch).to(dev))
        if log_every and i % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            log_fn(f"step {i}: loss={m['loss']:.4f} recon={m['recon']:.4f} kl={m['kl']:.4f}")
            log_metrics({"kind": "train", **m}, step=i)
    return state.model, state, {k: float(v) for k, v in metrics.items()}
