"""Covariance estimation and Gaussian precision / log-determinant — the port
of ``anuraxla/ops/linalg.py``.

The JAX package runs both matrix products at ``Precision.HIGHEST``; here
they run under ``utils.precision.exact_f32()`` (TF32 off on the card).
``torch.linalg.cholesky`` raises on a matrix that is not positive definite,
where ``jnp.linalg.cholesky`` returns NaNs that the reference tests with
``isfinite``: ``cholesky_ex``'s status selects the +1e-3·I repair per
matrix instead.
"""

from __future__ import annotations

import math

import torch

from anuraxla_torch.utils.precision import exact_f32


def masked_mean(Z: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over valid rows. Z: [N, D], mask: [N] -> [D]."""
    w = mask.to(Z.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    return (Z * w[:, None]).sum(dim=0) / n


def masked_cov(Z: torch.Tensor, mask: torch.Tensor, mu: torch.Tensor | None = None) -> torch.Tensor:
    """Unbiased sample covariance over valid rows (np.cov bias=False).

    Z: [N, D], mask: [N] -> [D, D]; I with fewer than 2 valid rows. With
    ``mu`` the data is centred at ``mu`` and the divisor stays n − 1 (the
    reference's LDA path)."""
    d = Z.shape[1]
    w = mask.to(Z.dtype)
    n = w.sum()
    mu = masked_mean(Z, mask) if mu is None else mu
    Zc = (Z - mu[None, :]) * w[:, None]
    with exact_f32():
        cov = (Zc.T @ Zc) / torch.clamp(n - 1.0, min=1.0)
    return torch.where(n >= 2.0, cov, torch.eye(d, dtype=Z.dtype, device=Z.device))


def regularize_cov(cov: torch.Tensor, *, eps: float, shrink: float, diag_only: bool = False) -> torch.Tensor:
    """eps·I jitter + shrinkage toward mean-variance·I + optional diagonal
    structure, in the reference's order."""
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    if diag_only:
        cov = eye * torch.diagonal(cov, dim1=-2, dim2=-1)[..., None, :]
    if shrink > 0:
        avg_var = torch.diagonal(cov, dim1=-2, dim2=-1).mean(dim=-1)[..., None, None]
        cov = (1.0 - shrink) * cov + shrink * avg_var * eye
    return cov + eps * eye


def inv_and_logdet(cov: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(precision, logdet) via Cholesky, with the reference's non-PD repair:
    a matrix whose factorization fails is factored again with +1e-3·I (and
    gives NaNs if that fails too, as the reference's does).

    cov: [..., D, D] -> (prec [..., D, D], logdet [...])."""
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)

    def chol(c):
        L, info = torch.linalg.cholesky_ex(c)
        ok = (info == 0) & torch.isfinite(L).all(dim=-1).all(dim=-1)
        return L, ok

    L, ok = chol(cov)
    L2, ok2 = chol(cov + 1e-3 * eye)
    L2 = torch.where(ok2[..., None, None], L2, torch.full_like(L2, float("nan")))
    L = torch.where(ok[..., None, None], L, L2)

    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(dim=-1)
    inv_L = torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)
    with exact_f32():
        prec = inv_L.transpose(-1, -2) @ inv_L
    return prec.to(torch.float32), logdet


def gaussian_log_likelihood(
    Z: torch.Tensor, means: torch.Tensor, precisions: torch.Tensor, logdets: torch.Tensor,
) -> torch.Tensor:
    """Batched log N(z | mu_k, Sigma_k) from precision matrices.

    Z: [B, D]; means: [K, D]; precisions: [K, D, D]; logdets: [K] -> [B, K]."""
    d = Z.shape[-1]
    diff = Z[:, None, :] - means[None, :, :]  # [B, K, D]
    with exact_f32():
        quad = torch.einsum("bkd,kde,bke->bk", diff, precisions, diff)
    # the reference takes log(2π) in f32
    log_2pi = torch.log(torch.tensor(2.0 * math.pi, dtype=torch.float32, device=Z.device))
    return -0.5 * (quad + logdets[None, :] + d * log_2pi)
