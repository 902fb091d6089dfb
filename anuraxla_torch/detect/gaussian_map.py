"""Gaussian MAP (LDA/QDA) detector — the port of
``anuraxla/detect/gaussian_map.py`` (``MapFit``, ``fit_map``,
``map_decide``, ``true_class_score_summary``).

  score_k(z) = log N(z | mu_k, Sigma_k) + log(pi_k + 1e-12)
  pred       = argmax_k score_k
  NO_DETECT  iff tau is set and max_k score_k < tau
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from anuraxla_torch.ops.linalg import gaussian_log_likelihood, inv_and_logdet, masked_cov, regularize_cov
from anuraxla_torch.ops.quantiles import masked_quantile


@dataclasses.dataclass
class MapFit:
    means: torch.Tensor  # [K, D]
    covs: torch.Tensor  # [K, D, D]
    precisions: torch.Tensor  # [K, D, D]
    logdets: torch.Tensor  # [K]
    priors: torch.Tensor  # [K]
    tau: torch.Tensor  # scalar (nan == disabled)
    scores_true_sorted: torch.Tensor  # [K*Nmax] ascending (+inf pad), for tau sweeps
    n_scores: torch.Tensor  # scalar valid count


def fit_map(
    Z: torch.Tensor,
    mask: torch.Tensor,
    *,
    cov_type: str = "lda",
    cov_structure: str = "full",
    priors_mode: str = "empirical",
    eps: float = 1e-6,
    shrink: float = 0.0,
    tau_q: Optional[float] = None,
) -> MapFit:
    """Fit the MAP detector over padded per-species latents.

    Z: [K, Nmax, D]; mask: [K, Nmax]. cov_type: "lda" (pooled, shared) or
    "qda" (per class); cov_structure: "full" / "diag"; priors_mode:
    "empirical" / "uniform". ``tau_q`` sets tau to that quantile of the
    true-class training scores."""
    K, Nmax, D = Z.shape
    w = mask.to(Z.dtype)
    n_k = w.sum(dim=1)
    total = torch.clamp(n_k.sum(), min=1.0)
    means = (Z * w[..., None]).sum(dim=1) / torch.clamp(n_k, min=1.0)[:, None]
    priors = torch.full((K,), 1.0 / K, dtype=Z.dtype, device=Z.device) if priors_mode == "uniform" else n_k / total

    diag_only = cov_structure == "diag"
    if cov_type == "lda":
        # per-class-centred rows pooled, divisor N_total − 1 (np.cov over the pooled matrix)
        Zc = (Z - means[:, None, :]).reshape(K * Nmax, D)
        cov = masked_cov(Zc, mask.reshape(K * Nmax), mu=torch.zeros(D, dtype=Z.dtype, device=Z.device))
        cov = regularize_cov(cov, eps=eps, shrink=shrink, diag_only=diag_only)
        prec, ld = inv_and_logdet(cov)
        covs, precs, logdets = cov.expand(K, D, D), prec.expand(K, D, D), ld.expand(K)
    else:
        covs = torch.stack([
            regularize_cov(masked_cov(Z[k], mask[k], mu=means[k]), eps=eps, shrink=shrink, diag_only=diag_only)
            for k in range(K)
        ])
        precs, logdets = inv_and_logdet(covs)

    # true-class training scores (for tau and the meta summaries)
    log_priors = torch.log(priors + 1e-12)
    ll_all = gaussian_log_likelihood(Z.reshape(K * Nmax, D), means, precs, logdets)  # [K*Nmax, K]
    owner = torch.arange(K, device=Z.device).repeat_interleave(Nmax)
    scores_true = ll_all[torch.arange(K * Nmax, device=Z.device), owner] + log_priors[owner]
    flat_mask = mask.reshape(K * Nmax)
    inf = torch.full_like(scores_true, float("inf"))
    scores_true_sorted = torch.sort(torch.where(flat_mask, scores_true, inf)).values
    tau = (torch.tensor(float("nan"), device=Z.device) if tau_q is None
           else masked_quantile(scores_true, flat_mask, tau_q))

    return MapFit(
        means=means.to(torch.float32),
        covs=covs.to(torch.float32),
        precisions=precs.to(torch.float32),
        logdets=logdets.to(torch.float32),
        priors=priors.to(torch.float32),
        tau=tau,
        scores_true_sorted=scores_true_sorted,
        n_scores=flat_mask.sum(),
    )


def map_decide(
    Z: torch.Tensor,
    means: torch.Tensor,
    precisions: torch.Tensor,
    logdets: torch.Tensor,
    priors: torch.Tensor,
    tau: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched MAP decision. Z: [B, D] -> (detected [B], winner_idx [B]
    (−1 if rejected), best_score [B]). tau == nan disables rejection."""
    scores = gaussian_log_likelihood(Z, means, precisions, logdets) + torch.log(priors + 1e-12)[None, :]
    best = torch.argmax(scores, dim=1).to(torch.int32)
    best_score = scores.max(dim=1).values
    detected = ~(best_score < tau)  # a nan tau rejects nothing
    return detected, torch.where(detected, best, torch.full_like(best, -1)), best_score


def true_class_score_summary(fit: MapFit, Z: torch.Tensor, mask: torch.Tensor) -> dict:
    """Per-species min / p05 / p50 / p95 / max of the true-class scores."""
    K = Z.shape[0]
    log_priors = torch.log(fit.priors + 1e-12)
    rows = []
    for k in range(K):
        s = gaussian_log_likelihood(Z[k], fit.means, fit.precisions, fit.logdets)[:, k] + log_priors[k]
        m = mask[k]
        qs = masked_quantile(s, m, [0.05, 0.5, 0.95])
        rows.append({
            "min": torch.where(m, s, torch.full_like(s, float("inf"))).min(),
            "p05": qs[0], "p50": qs[1], "p95": qs[2],
            "max": torch.where(m, s, torch.full_like(s, -float("inf"))).max(),
        })
    return {key: torch.stack([r[key] for r in rows]) for key in rows[0]}
