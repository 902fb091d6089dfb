"""Distributed detector fitting with the latents split over the mesh's data
shards end to end — the port of ``anuraxla/parallel/fit.py``.

Only two kinds of data leave a shard:

- ``psum``'d moments: per-class counts and sums (means, priors) and
  per-class Gram matrices (TF32 off; the pooled LDA covariance with the
  n − 1 divisor of ``ops.linalg.masked_cov``);
- the scalar distance / score pools ([K, N] f32, D times smaller than the
  latents), gathered in shard order for the sort that gives ``np.quantile``'s
  linear interpolation. ``sharded_quantile`` gets the same answer without
  gathering even those, from ``psum``'d histograms and count bisection.

The fits return the port's ``RadialFit`` / ``MapFit`` on the mesh's first
device, with their pools padded to a multiple of the data axis; every
consumer (config writer, calibration sweep, benchmark) takes them unchanged.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from anuraxla_torch.detect.gaussian_map import MapFit
from anuraxla_torch.detect.radial import RadialFit, _pairwise_dist
from anuraxla_torch.ops.linalg import gaussian_log_likelihood, inv_and_logdet, regularize_cov
from anuraxla_torch.ops.quantiles import masked_quantile
from anuraxla_torch.parallel.encode import histogram_parts
from anuraxla_torch.parallel.mesh import Mesh, all_gather, pmax, psum, shard_along
from anuraxla_torch.utils.precision import exact_f32


def shard_species_latents(Z, mask, mesh: Mesh) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Padded [K, Nmax, D] latents (numpy or tensor) with the sample axis
    padded to a multiple of the data axis (pad rows masked out) and split
    over the data shards -> (Z parts [K, Ns, D], mask parts [K, Ns]), each on
    its shard's device: no device holds the full latent matrix. Every
    process passes the same global arrays and keeps its own shards."""
    return (shard_along(Z, mesh, axis=1, dtype=torch.float32),
            shard_along(mask, mesh, axis=1, dtype=torch.bool))


def fit_radial_sharded(Z, mask, q_in, q_out, *, mesh: Mesh) -> RadialFit:
    """fit_radial over sample-sharded latents. Z: [K, Nmax, D], mask:
    [K, Nmax]. Returns the same RadialFit as detect.radial (distance pools
    padded to a multiple of the data axis)."""
    Zs, ms = shard_species_latents(Z, mask, mesh)
    n_in = psum([m.sum(dim=1) for m in ms], mesh)  # [K]
    sums = psum([(z * m.to(z.dtype)[..., None]).sum(dim=1) for z, m in zip(Zs, ms)], mesh)
    mus = sums / torch.clamp(n_in, min=1).to(sums.dtype)[:, None]
    rho_in, d_all, out_mask = [], [], []
    for z, m in zip(Zs, ms):
        K, Ns, D = z.shape
        mu = mus.to(z.device)
        diff_in = z - mu[:, None, :]
        rho_in.append(torch.sqrt(torch.clamp(torch.sum(diff_in * diff_in, dim=-1), min=0.0)))
        d_all.append(_pairwise_dist(z.reshape(K * Ns, D), mu).T)  # [K, K·Ns]
        owner = torch.arange(K, device=z.device).repeat_interleave(Ns)
        out_mask.append(m.reshape(K * Ns)[None, :] & (owner[None, :] != torch.arange(K, device=z.device)[:, None]))
    # quantiles need a global sort: only these scalar pools are gathered
    rho_in, d_all = all_gather(rho_in, mesh, dim=1), all_gather(d_all, mesh, dim=1)
    md, out_mask = all_gather(ms, mesh, dim=1), all_gather(out_mask, mesh, dim=1)
    rk_in = masked_quantile(rho_in, md, q_in)
    n_out = out_mask.sum(dim=1)
    inf = torch.tensor(float("inf"), dtype=rho_in.dtype, device=rho_in.device)
    rk_out = torch.where(n_out > 0, masked_quantile(d_all, out_mask, q_out), inf)
    return RadialFit(
        centroids=mus.to(torch.float32),
        rk=torch.minimum(rk_in, rk_out),
        rk_in=rk_in,
        rk_out=rk_out,
        rho_in_sorted=torch.sort(torch.where(md, rho_in, inf), dim=1).values,
        n_in=n_in,
        rho_out_sorted=torch.sort(torch.where(out_mask, d_all, inf), dim=1).values,
        n_out=n_out,
    )


def fit_map_sharded(
    Z,
    mask,
    *,
    mesh: Mesh,
    cov_type: str = "lda",
    cov_structure: str = "full",
    priors_mode: str = "empirical",
    eps: float = 1e-6,
    shrink: float = 0.0,
    tau_q: float | None = None,
) -> MapFit:
    """fit_map over sample-sharded latents: ``psum``'d means, priors and
    pooled (LDA) or per-class (QDA) Gram matrices; τ from the exact quantile
    of the gathered scalar score pool. Same MapFit as detect.gaussian_map."""
    Zs, ms = shard_species_latents(Z, mask, mesh)
    K, _, D = Zs[0].shape
    dev = mesh.devices[0]
    n_k = psum([m.to(torch.float32).sum(dim=1) for m in ms], mesh)  # [K]
    means = psum([(z * m.to(z.dtype)[..., None]).sum(dim=1) for z, m in zip(Zs, ms)], mesh) \
        / torch.clamp(n_k, min=1.0)[:, None]
    grams = []
    for z, m in zip(Zs, ms):
        zc = (z - means.to(z.device)[:, None, :]) * m.to(z.dtype)[..., None]
        with exact_f32():
            grams.append(torch.einsum("kni,knj->kij", zc, zc))
    gram_k = psum(grams, mesh)

    total = torch.clamp(n_k.sum(), min=1.0)
    priors = torch.full((K,), 1.0 / K, dtype=torch.float32, device=dev) if priors_mode == "uniform" else n_k / total
    diag_only = cov_structure == "diag"
    eye = torch.eye(D, dtype=torch.float32, device=dev)
    if cov_type == "lda":
        # pooled-centred cov, divisor N_total − 1 (masked_cov semantics)
        cov = gram_k.sum(dim=0) / torch.clamp(total - 1.0, min=1.0)
        cov = torch.where(total >= 2.0, cov, eye)
        cov = regularize_cov(cov, eps=eps, shrink=shrink, diag_only=diag_only)
        prec, ld = inv_and_logdet(cov)
        covs, precs, logdets = cov.expand(K, D, D), prec.expand(K, D, D), ld.expand(K)
    else:
        covs = gram_k / torch.clamp(n_k - 1.0, min=1.0)[:, None, None]
        covs = torch.where((n_k >= 2.0)[:, None, None], covs, eye[None])
        covs = regularize_cov(covs, eps=eps, shrink=shrink, diag_only=diag_only)
        precs, logdets = inv_and_logdet(covs)

    log_priors = torch.log(priors + 1e-12)
    scores, flat = [], []
    for z, m in zip(Zs, ms):
        Ns, d = z.shape[1], z.device
        ll = gaussian_log_likelihood(z.reshape(K * Ns, D), means.to(d), precs.to(d), logdets.to(d))
        owner = torch.arange(K, device=d).repeat_interleave(Ns)
        scores.append(ll[torch.arange(K * Ns, device=d), owner] + log_priors.to(d)[owner])
        flat.append(m.reshape(K * Ns))
    scores_true, flat_mask = all_gather(scores, mesh), all_gather(flat, mesh)
    inf = torch.full_like(scores_true, float("inf"))
    tau = (torch.tensor(float("nan"), device=dev) if tau_q is None
           else masked_quantile(scores_true, flat_mask, tau_q))
    return MapFit(
        means=means.to(torch.float32),
        covs=covs.to(torch.float32),
        precisions=precs.to(torch.float32),
        logdets=logdets.to(torch.float32),
        priors=priors.to(torch.float32),
        tau=tau,
        scores_true_sorted=torch.sort(torch.where(flat_mask, scores_true, inf)).values,
        n_scores=flat_mask.sum(),
    )


def sharded_quantile(
    d,
    mask,
    q: float,
    *,
    mesh: Mesh,
    n_bins: int = 8192,
    n_refine: int = 2,
    empty_fill: float = np.inf,
    max_bisect: int = 160,
) -> torch.Tensor:
    """EXACT global quantile (``np.quantile``'s linear interpolation) of
    sample-sharded per-row pools without gathering even the scalar pool.
    d, mask: [K, N] (split on axis 1 over the data shards) -> [K].

    Three phases, each pass O(N / shards) with only [K]- or [K, n_bins]-sized
    ``psum`` / ``pmax`` leaving a shard:

    1. ``n_refine`` histogram passes, each narrowing the bracket around the
       rank-⌊q·(n−1)⌋ order statistic n_bins-fold (the chosen bin widened by
       one on each side, so float binning cannot break the bracket), then an
       exact-count check of the bracket that falls back to the initial
       endpoints where binning collapsed one;
    2. count bisection, a host loop that syncs once an iteration on its exit
       test: it keeps count(x ≤ lo) ≤ r1 < count(x ≤ hi) and stops when
       min{x > lo} is provably x_(r1) for every non-empty row — the exit
       test is the exactness certificate; ``max_bisect`` bounds it;
    3. s1 = x_(r1), s2 = x_(r1+1) (s1 where the next sample ties it), and
       s1·(1 − frac) + s2·frac in f32: the order statistics and arithmetic
       of ``ops.quantiles``, so it matches ``masked_quantile`` within 1 ulp.

    Empty rows give ``empty_fill``: +inf is the never-constrain convention
    of rk_out, 0.0 the reference's ``quantile_safe`` for rk_in-style pools.
    """
    dp = shard_along(d, mesh, axis=1, dtype=torch.float32)
    mp = shard_along(mask, mesh, axis=1, dtype=torch.bool)
    K = dp[0].shape[0]
    inf = float("inf")

    def count_le_min_above(t: torch.Tensor):
        """Per row k: (count(x ≤ t_k), min{x > t_k} or +inf) in one pass —
        a ``psum``'d count and a ``pmax``'d negated min, both exact."""
        le, mn = [], []
        for x, m in zip(dp, mp):
            tk = t.to(x.device)[:, None]
            le.append((m & (x <= tk)).sum(dim=1))
            mn.append(-torch.where(m & (x > tk), x, inf).min(dim=1).values)
        return psum(le, mesh), -pmax(mn, mesh)

    lo0 = -pmax([-torch.where(m, x, inf).min(dim=1).values for x, m in zip(dp, mp)], mesh)  # [K]
    hi0 = pmax([torch.where(m, x, -inf).max(dim=1).values for x, m in zip(dp, mp)], mesh)
    n = psum([m.sum(dim=1) for m in mp], mesh)  # [K]
    pos = torch.tensor(q, dtype=torch.float32) * torch.clamp(n - 1, min=0).to(torch.float32)
    r1 = torch.floor(pos).to(torch.int64)
    frac = pos - r1.to(torch.float32)
    # f(lo) ≤ r1 needs lo strictly below the pool minimum
    lo_init = lo0 - torch.clamp(torch.abs(lo0) * 1e-3, min=1e-3)

    lo, hi = lo_init, hi0
    for _ in range(n_refine):
        bins = torch.cumsum(histogram_parts(dp, mp, lo, hi, n_bins, mesh), dim=1)  # [K, n_bins]
        b = torch.argmax((bins > r1[:, None].to(torch.float32)).to(torch.uint8), dim=1)  # first true
        width = torch.clamp(hi - lo, min=1e-12) / n_bins
        # ±1-bin safety margin: float binning may misplace edge samples
        lo, hi = (torch.maximum(lo + (b - 1).to(torch.float32) * width, lo),
                  torch.minimum(lo + (b + 2).to(torch.float32) * width, hi))
    c_lo, _ = count_le_min_above(lo)
    lo = torch.where(c_lo <= r1, lo, lo_init)
    c_hi, _ = count_le_min_above(hi)
    hi = torch.where(c_hi >= r1 + 1, hi, hi0)

    # the state carries the certificate (s = min{x > lo}, c_s = count(x ≤ s)):
    # two passes an iteration, the midpoint's s free when it takes the lower half
    _, s = count_le_min_above(lo)
    c_s, _ = count_le_min_above(s)
    for _ in range(max_bisect):
        if bool(torch.all((c_s >= r1 + 1) | (n == 0))):  # min{x > lo} already IS x_(r1)
            break
        m = 0.5 * (lo + hi)
        c_m, s_m = count_le_min_above(m)
        take_lo = c_m <= r1
        s = torch.where(take_lo, s_m, s)
        c_s, _ = count_le_min_above(s)
        lo, hi = torch.where(take_lo, m, lo), torch.where(take_lo, hi, m)
    # s = min{x > lo} = x_(r1); one more pass for its successor
    _, above_s1 = count_le_min_above(s)
    s2 = torch.where(c_s >= r1 + 2, s, above_s1)  # x_(r1+1)
    res = torch.where(frac > 0, s * (1.0 - frac) + s2 * frac, s)
    return torch.where(n > 0, res, torch.tensor(empty_fill, dtype=torch.float32, device=res.device))


def sharded_quantile_approx(d, mask, q, *, mesh, n_bins=8192, n_refine=2, **kw):
    """Backward-compatible alias — the escape hatch is exact now."""
    return sharded_quantile(d, mask, q, mesh=mesh, n_bins=n_bins, n_refine=n_refine, **kw)
