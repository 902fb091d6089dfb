"""Calibration sweeps on the latents' device — the port of
``anuraxla/detect/calibrate.py`` (``GridMetrics``, ``radial_qgrid``,
``map_tau_sweep``).

The reference's q_out grid (``run_qout_grid.sh``, ``9200``) re-runs fit and
benchmark once per point. Latents do not depend on q, so the grid is: encode
once, then threshold and decide over every (q_in, q_out) pair as batched
tensor ops. The MAP detector's τ is swept the same way.

The reference vmaps ``radial_decide`` over the [Qi, Qo] thresholds; here the
[B, K] distances are computed once (``radial._pairwise_dist``: broadcast
differences, not ``cdist``, whose matmul form moves the last bits) and
compared against all [Qi, Qo, K] thresholds by broadcasting, with
``radial_decide``'s tie-break (lowest priority rank among accepted species,
the first on a tie). Quantiles go through ``ops.quantiles.quantile_sorted``,
the reference's f32 position arithmetic. A rate over the whole batch is its
count times the f32 reciprocal of the batch size, which is how XLA computes
the reference's ``jnp.mean`` (a division by a constant becomes a product),
and which differs from a true division in the last bit (31/40); a rate over a
computed count (masked rows, per class) is a true division, as there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from anuraxla_torch.detect.radial import RadialFit, _pairwise_dist
from anuraxla_torch.ops.linalg import gaussian_log_likelihood
from anuraxla_torch.ops.quantiles import quantile_sorted


@dataclasses.dataclass
class GridMetrics:
    """Per grid point: global and per-class accuracy and NO_DETECT rates.
    Shapes: [Qi, Qo] or [Qi, Qo, K]."""

    accuracy: torch.Tensor
    no_detect_rate: torch.Tensor
    acc_per_class: torch.Tensor
    no_detect_per_class: torch.Tensor
    thresholds: torch.Tensor  # [Qi, Qo, K] fitted rk
    rk_in: torch.Tensor  # [Qi, K]
    rk_out: torch.Tensor  # [Qo, K]


def _metrics_from_decisions(detected, winner, true_idx, K: int, valid: Optional[torch.Tensor] = None):
    """Decision tensors [..., B] -> (accuracy [...], no_detect [...],
    acc_per_class [..., K], no_detect_per_class [..., K]). ``valid`` [B]
    masks out padding rows."""
    correct = (detected & (winner == true_idx)).to(torch.float32)
    missed = (~detected).to(torch.float32)
    onehot = torch.nn.functional.one_hot(true_idx.to(torch.int64), K).to(torch.float32)  # [B, K]
    if valid is None:
        inv_n = _f32_reciprocal(true_idx.shape[0], true_idx.device)
        acc, nodet = correct.sum(dim=-1) * inv_n, missed.sum(dim=-1) * inv_n
    else:
        v = valid.to(torch.float32)
        n = torch.clamp(v.sum(), min=1.0)
        correct, missed, onehot = correct * v, missed * v, onehot * v[:, None]
        acc, nodet = correct.sum(dim=-1) / n, missed.sum(dim=-1) / n
    n_per = torch.clamp(onehot.sum(dim=0), min=1.0)  # [K]
    accp = torch.einsum("...b,bk->...k", correct, onehot) / n_per
    nodp = torch.einsum("...b,bk->...k", missed, onehot) / n_per
    return acc, nodet, accp, nodp


def _f32_reciprocal(n: int, device) -> torch.Tensor:
    return torch.tensor(1.0 / n, dtype=torch.float32, device=device)


def radial_qgrid(
    fit: RadialFit,
    Z_eval: torch.Tensor,
    true_idx: torch.Tensor,
    priority_rank: torch.Tensor,
    q_in_grid,
    q_out_grid,
    valid: Optional[torch.Tensor] = None,
) -> GridMetrics:
    """Evaluate the radial detector over a full (q_in × q_out) grid.

    fit: RadialFit from the train latents (its sorted distance pools make each
    grid point K threshold lookups). Z_eval: [B, D] validation latents with
    integer labels true_idx [B], on the fit's device. Returns GridMetrics over
    [Qi, Qo]."""
    dev = fit.centroids.device
    K = fit.centroids.shape[0]
    q_in = torch.as_tensor(q_in_grid, dtype=torch.float32, device=dev)
    q_out = torch.as_tensor(q_out_grid, dtype=torch.float32, device=dev)

    rk_in = quantile_sorted(fit.rho_in_sorted, q_in[:, None], fit.n_in)  # [Qi, K]
    rk_out_q = quantile_sorted(fit.rho_out_sorted, q_out[:, None], fit.n_out)  # [Qo, K]
    rk_out = torch.where(fit.n_out[None, :] > 0, rk_out_q, torch.full_like(rk_out_q, float("inf")))
    thr = torch.minimum(rk_in[:, None, :], rk_out[None, :, :])  # [Qi, Qo, K]

    d = _pairwise_dist(Z_eval, fit.centroids)  # [B, K], once for the whole grid
    accepted = d[None, None] <= thr[:, :, None, :]  # [Qi, Qo, B, K]
    detected = accepted.any(dim=-1)
    key = torch.where(accepted, priority_rank.to(torch.float32), torch.tensor(float("inf"), device=dev))
    winner = torch.where(detected, torch.argmin(key, dim=-1).to(torch.int32), -1)
    acc, nodet, accp, nodp = _metrics_from_decisions(detected, winner, true_idx, K, valid)
    return GridMetrics(
        accuracy=acc,
        no_detect_rate=nodet,
        acc_per_class=accp,
        no_detect_per_class=nodp,
        thresholds=thr,
        rk_in=rk_in,
        rk_out=rk_out,
    )


def map_tau_sweep(
    scores_true_sorted: torch.Tensor,
    n_scores: torch.Tensor,
    Z_eval: torch.Tensor,
    true_idx: torch.Tensor,
    means: torch.Tensor,
    precisions: torch.Tensor,
    logdets: torch.Tensor,
    priors: torch.Tensor,
    tau_q_grid,
):
    """Sweep τ over quantiles of the true-class train scores; returns
    (tau [Q], accuracy [Q], no_detect_rate [Q]). Scores computed once."""
    scores = gaussian_log_likelihood(Z_eval, means, precisions, logdets) + torch.log(priors + 1e-12)[None, :]
    best = torch.argmax(scores, dim=1)
    best_score = scores.max(dim=1).values
    q = torch.as_tensor(tau_q_grid, dtype=torch.float32, device=scores.device)
    taus = quantile_sorted(scores_true_sorted, q, n_scores)  # [Q]
    detected = best_score[None, :] >= taus[:, None]  # [Q, B]
    correct = detected & (best == true_idx)[None, :]
    inv_n = _f32_reciprocal(Z_eval.shape[0], scores.device)
    return taus, correct.to(torch.float32).sum(dim=1) * inv_n, (~detected).to(torch.float32).sum(dim=1) * inv_n
