"""Multi-shard VAE training: data parallelism over the mesh's data axis, with
the dense bottleneck's output columns optionally split over its model axis —
the port of ``anuraxla/parallel/train_sharded.py``.

JAX leaves the collectives to XLA's sharding propagation; here they are
written out. Each data shard holds a replica of the model on its device and
runs the forward and backward of its rows of the global batch; a dense layer
that the rule splits holds one slice of its output columns on each model
shard of the row, computes its slice there, and the slices are concatenated
on the row's first device. The gradients (and the loss terms) of all shards
are ``psum``'d in one flat buffer and divided by the data-axis size, which
gives the global batch's mean; one AdamW update (``models.train``'s
optimizer and schedule) is applied to the master parameters on the mesh's
first device, and every replica is refreshed from them.

The reparameterisation noise is drawn once for the global batch
(``models.train.step_noise``, or ``eps`` passed in) and split by rows, so a
sharded step computes what the unsharded one does, up to f32 sum order.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from anuraxla_torch.models.train import (
    TrainConfig, TrainState, create_train_state, kl_beta, step_noise, vae_loss,
)
from anuraxla_torch.models.vae import ConvVAE, VAEConfig
from anuraxla_torch.parallel.mesh import Mesh, make_mesh, psum
from anuraxla_torch.utils.metrics import log_metrics
from anuraxla_torch.utils.precision import exact_f32


def param_sharding_rules(mesh: Mesh):
    """-> rule(leaf) -> "model" | None: a 2-D kernel with both dims ≥ 128
    and its output dim divisible by the model axis is split on its output
    dim (the flatten -> dense bottleneck is the only big matmul); everything
    else is replicated. A torch ``Linear`` weight is [out, in], so the
    output dim is dim 0 (flax's kernel is [in, out]). With model_axis=1 this
    is pure replication (plain DP)."""
    model_size = mesh.shape["model"]

    def rule(leaf) -> Optional[str]:
        if (model_size > 1 and isinstance(leaf, torch.Tensor) and leaf.ndim == 2
                and min(leaf.shape) >= 128 and leaf.shape[0] % model_size == 0):
            return "model"
        return None

    return rule


class ColumnSplitDense(nn.Module):
    """A dense layer whose output columns are split over the model shards of
    one data row: slice j of the weight and bias lives on ``devices[j]``,
    computes its columns there (in the input's dtype, as ``models.vae.dense``
    does), and the slices are concatenated on the input's device."""

    def __init__(self, layer: nn.Linear, devices: List[torch.device]):
        super().__init__()
        self.devices = devices
        m = len(devices)
        self.weights = nn.ParameterList(
            [nn.Parameter(w.detach().to(d).clone()) for w, d in zip(layer.weight.chunk(m, 0), devices)])
        self.biases = nn.ParameterList(
            [nn.Parameter(b.detach().to(d).clone()) for b, d in zip(layer.bias.chunk(m, 0), devices)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([F.linear(x.to(d), w.to(x.dtype), b.to(x.dtype)).to(x.device)
                          for d, w, b in zip(self.devices, self.weights, self.biases)], dim=-1)


@dataclasses.dataclass
class ShardedState:
    """The master train state (model, AdamW, schedule, step) on the mesh's
    first device, one model replica per local data shard, and for each
    replica the binding of every master parameter to the replica tensors
    (with their row slice) that hold it."""

    state: TrainState
    replicas: List[ConvVAE]
    binds: List[List[Tuple[nn.Parameter, List[Tuple[nn.Parameter, Optional[slice]]]]]]


def _replica(master: ConvVAE, devices: List[torch.device], split: set):
    """A copy of ``master`` on ``devices[0]`` with the ``split`` dense layers
    made ``ColumnSplitDense`` over ``devices``, and its parameter binding."""
    rep = copy.deepcopy(master).to(devices[0])
    for name in split:
        parent, _, attr = name.rpartition(".")
        owner = rep.get_submodule(parent) if parent else rep
        setattr(owner, attr, ColumnSplitDense(getattr(owner, attr), devices))
    rep_params = dict(rep.named_parameters())
    binds = []
    for name, p in master.named_parameters():
        layer, _, kind = name.rpartition(".")
        if layer in split:
            rows = p.shape[0] // len(devices)
            key = {"weight": "weights", "bias": "biases"}[kind]
            parts = [(rep_params[f"{layer}.{key}.{j}"], slice(j * rows, (j + 1) * rows))
                     for j in range(len(devices))]
        else:
            parts = [(rep_params[name], None)]
        binds.append((p, parts))
    return rep, binds


def shard_state(state: TrainState, mesh: Mesh):
    """-> (ShardedState, shardings): a replica of ``state.model`` for each
    local data shard, the dense layers the rule picks split over the row's
    model shards; ``shardings`` maps each parameter name to "model" (split
    with its layer) or None (replicated)."""
    rule = param_sharding_rules(mesh)
    split = {name for name, mod in state.model.named_modules()
             if isinstance(mod, nn.Linear) and rule(mod.weight) == "model"}
    shardings = {name: ("model" if name.rpartition(".")[0] in split else None)
                 for name, _ in state.model.named_parameters()}
    reps = [_replica(state.model, mesh.model_devices(i), split) for i in range(mesh.local_data)]
    return ShardedState(state, [r for r, _ in reps], [b for _, b in reps]), shardings


def make_sharded_train_step(beta: float, mesh: Mesh, kl_warmup_steps: int = 0, kl_delay_steps: int = 0, *,
                            seed: int = 0):
    """-> step(sstate, batch, eps=None) -> (sstate, metrics): one AdamW
    update from the global batch [B, T, M, 1] (B divisible by the data
    axis; every process passes the same batch and runs its own shards'
    rows). ``eps`` [B, latent_dim] defaults to ``step_noise(seed, step)`` of
    the whole batch on the mesh's first device. The metrics are the global
    batch's, on that device."""
    nd = mesh.shape["data"]

    def step(ss: ShardedState, batch: torch.Tensor, eps: Optional[torch.Tensor] = None):
        master = ss.state
        dev0 = mesh.devices[0]
        if eps is None:
            eps = step_noise(seed, master.step, (batch.shape[0], master.model.cfg.latent_dim), dev0)
        b_t = kl_beta(beta, master.step, kl_warmup_steps, kl_delay_steps)
        flats = []
        with exact_f32():
            for i, (a, b) in enumerate(mesh.local_slices(batch.shape[0])):
                dev = mesh.data_devices[i]
                loss, m = vae_loss(ss.replicas[i], batch[a:b].to(dev), eps[a:b].to(dev), b_t)
                loss.backward()
                grads = [torch.cat([rp.grad.to(dev0) for rp, _ in parts]) if len(parts) > 1
                         else parts[0][0].grad.to(dev0) for _, parts in ss.binds[i]]
                flats.append(torch.cat([g.reshape(-1) for g in grads]
                                       + [torch.stack([m["loss"], m["recon"], m["kl"]]).to(dev0)]))
            total = psum(flats, mesh) / nd
            off = 0
            for p, _ in ss.binds[0]:
                p.grad = total[off : off + p.numel()].view_as(p)
                off += p.numel()
            metrics = dict(zip(("loss", "recon", "kl"), total[off:]))
            for group in master.optimizer.param_groups:
                group["lr"] = master.schedule(master.step)
            master.optimizer.step()
            master.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            for binds in ss.binds:
                for p, parts in binds:
                    for rp, rows in parts:
                        rp.copy_(p if rows is None else p[rows])
                        rp.grad = None
        master.step += 1
        return ss, metrics

    return step


def train_loop_sharded(
    cfg: VAEConfig,
    tc: TrainConfig,
    batch_iter: Iterator,
    *,
    num_steps: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    model_axis: int = 1,
    log_every: int = 50,
    log_fn=print,
    device="cuda",
):
    """Sharded twin of ``models.train.train_loop``. Batches must divide by
    the data axis (the loader's batches are fixed, so they do). -> (vae, the
    master TrainState — a plain one, which ``save_encoder`` and
    ``encoder_params_from_vae`` take unchanged — and the last metrics)."""
    mesh = mesh or make_mesh(model_axis=model_axis, device=device)
    _, state = create_train_state(cfg, tc, device=mesh.devices[0])
    ss, _ = shard_state(state, mesh)
    step_fn = make_sharded_train_step(tc.beta, mesh, tc.kl_warmup_steps, tc.kl_delay_steps, seed=tc.seed)
    n = num_steps if num_steps is not None else tc.total_steps
    metrics = {}
    for i, batch in enumerate(itertools.islice(batch_iter, n)):
        ss, metrics = step_fn(ss, torch.as_tensor(batch))
        if log_every and i % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            log_fn(f"step {i} [{mesh.shape['data']}dp x {mesh.shape['model']}tp]: "
                   f"loss={m['loss']:.4f} recon={m['recon']:.4f} kl={m['kl']:.4f}")
            log_metrics({"kind": "train", "dp": mesh.shape["data"], "tp": mesh.shape["model"], **m}, step=i)
    return ss.state.model, ss.state, {k: float(v) for k, v in metrics.items()}
