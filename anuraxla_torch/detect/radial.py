"""Radial (centroid + radius) detector — the port of
``anuraxla/detect/radial.py`` (``RadialFit``, ``fit_radial``,
``thresholds_for_q``, ``_pairwise_dist``, ``radial_decide``).

  mu_k   = mean(Z_k)
  rk_in  = quantile(||Z_k − mu_k||, q_in)
  rk_out = quantile(||Z_other − mu_k||, q_out)   (inf if no other class)
  rk     = min(rk_in, rk_out)

Accept species k for z iff ||z − mu_k|| <= rk; among accepted species the
lowest priority rank wins (``config.priority_ranks``); no accept gives −1.
Distances are broadcast differences, as in the reference: ``torch.cdist``
switches to a matmul form above 25 rows, which moves ``rk`` in the last bits
(and in TF32 by far more).
"""

from __future__ import annotations

import dataclasses

import torch

from anuraxla_torch.ops.quantiles import masked_quantile, quantile_sorted


@dataclasses.dataclass
class RadialFit:
    """Fitted radial detector (species axis ordered as input)."""

    centroids: torch.Tensor  # [K, D]
    rk: torch.Tensor  # [K]
    rk_in: torch.Tensor  # [K]
    rk_out: torch.Tensor  # [K]  (inf when no out-of-class samples)
    rho_in_sorted: torch.Tensor  # [K, Nmax] ascending, +inf padded
    n_in: torch.Tensor  # [K]
    rho_out_sorted: torch.Tensor  # [K, K*Nmax] ascending, +inf padded
    n_out: torch.Tensor  # [K]


def _pairwise_dist(Z: torch.Tensor, mus: torch.Tensor) -> torch.Tensor:
    """||z_b − mu_k|| for Z [B, D], mus [K, D] -> [B, K]."""
    diff = Z[:, None, :] - mus[None, :, :]
    return torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=0.0))


def fit_radial(Z: torch.Tensor, mask: torch.Tensor, q_in: float, q_out: float) -> RadialFit:
    """Fit all species at once. Z: [K, Nmax, D] padded latents; mask:
    [K, Nmax] validity; q_in / q_out: scalars."""
    K, Nmax, D = Z.shape
    w = mask.to(Z.dtype)
    n_in = mask.sum(dim=1)
    mus = (Z * w[..., None]).sum(dim=1) / torch.clamp(n_in, min=1)[:, None].to(Z.dtype)

    diff_in = Z - mus[:, None, :]
    rho_in = torch.sqrt(torch.clamp(torch.sum(diff_in * diff_in, dim=-1), min=0.0))
    rk_in = masked_quantile(rho_in, mask, q_in)

    # every sample's distance to every centroid [K, K*Nmax]
    d_all = _pairwise_dist(Z.reshape(K * Nmax, D), mus).T
    owner = torch.arange(K, device=Z.device).repeat_interleave(Nmax)
    out_mask = mask.reshape(K * Nmax)[None, :] & (owner[None, :] != torch.arange(K, device=Z.device)[:, None])
    n_out = out_mask.sum(dim=1)
    inf = torch.tensor(float("inf"), dtype=Z.dtype, device=Z.device)
    rk_out = torch.where(n_out > 0, masked_quantile(d_all, out_mask, q_out), inf)
    rk = torch.minimum(rk_in, rk_out)

    return RadialFit(
        centroids=mus.to(torch.float32),
        rk=rk,
        rk_in=rk_in,
        rk_out=rk_out,
        rho_in_sorted=torch.sort(torch.where(mask, rho_in, inf), dim=1).values,
        n_in=n_in,
        rho_out_sorted=torch.sort(torch.where(out_mask, d_all, inf), dim=1).values,
        n_out=n_out,
    )


def thresholds_for_q(fit: RadialFit, q_in: float, q_out: float) -> torch.Tensor:
    """rk = min(rk_in(q_in), rk_out(q_out)) from the fit's sorted distance
    pools, without re-encoding. Scalars -> [K]."""
    rk_in = quantile_sorted(fit.rho_in_sorted, q_in, fit.n_in)
    rk_out = quantile_sorted(fit.rho_out_sorted, q_out, fit.n_out)
    rk_out = torch.where(fit.n_out > 0, rk_out, torch.full_like(rk_out, float("inf")))
    return torch.minimum(rk_in, rk_out)


def radial_decide(
    Z: torch.Tensor,
    centroids: torch.Tensor,
    thresholds: torch.Tensor,
    priority_rank: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched accept + tie-break. Z [B, D]; centroids [K, D]; thresholds
    [K]; priority_rank [K] (lower wins). Returns (detected [B] bool,
    winner [B] int32 (−1 if none), best_distance [B] = min_k ||z − mu_k||)."""
    d = _pairwise_dist(Z, centroids)
    accepted = d <= thresholds[None, :]
    detected = accepted.any(dim=1)
    key = torch.where(
        accepted, priority_rank[None, :].to(torch.float32), torch.full_like(d, float("inf"))
    )
    winner = torch.argmin(key, dim=1).to(torch.int32)
    winner = torch.where(detected, winner, torch.full_like(winner, -1))
    return detected, winner, d.min(dim=1).values
