"""Radial (centroid + radius) detector decision — the port of
``anuraxla/detect/radial.py``'s ``_pairwise_dist`` and ``radial_decide``.

Accept species k for z iff ||z − mu_k|| <= rk; among accepted species the
lowest priority rank wins (``config.priority_ranks``); no accept gives −1.
"""

from __future__ import annotations

import torch


def _pairwise_dist(Z: torch.Tensor, mus: torch.Tensor) -> torch.Tensor:
    """||z_b − mu_k|| for Z [B, D], mus [K, D] -> [B, K]."""
    diff = Z[:, None, :] - mus[None, :, :]
    return torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=0.0))


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
