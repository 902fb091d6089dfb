"""Quantiles with ``np.quantile`` (linear interpolation) semantics — the port
of ``anuraxla/ops/quantiles.py``.

The reference's own arithmetic, not ``torch.quantile`` (whose position
arithmetic and dtype differ): the position ``q·(n − 1)`` in f32, invalid
entries padded with +inf and sorted to the end, the upper neighbour clamped
to the last valid entry, and 0.0 for a row with no valid entry.
"""

from __future__ import annotations

import torch


def quantile_sorted(x_sorted: torch.Tensor, q, n_valid) -> torch.Tensor:
    """Linear-interpolated quantile(s) of pre-sorted data.

    x_sorted: [..., N] ascending, invalid entries sorted to the end (+inf
    padding). ``n_valid`` counts the valid entries (broadcastable to
    x_sorted[..., 0]); q is a scalar or any shape that broadcasts with the
    batch dims. Result: broadcast(q, batch dims of x_sorted)."""
    dev = x_sorted.device
    n_valid = torch.as_tensor(n_valid, device=dev)
    q = torch.as_tensor(q, dtype=torch.float32, device=dev)
    last = (n_valid - 1).to(torch.float32)
    pos = q * last
    N = x_sorted.shape[-1]
    lo = torch.clamp(torch.floor(pos).to(torch.int32), 0, N - 1)
    hi = torch.clamp(lo + 1, 0, N - 1)
    frac = pos - lo.to(torch.float32)
    shape = torch.broadcast_shapes(x_sorted.shape[:-1], lo.shape)
    xs = x_sorted.expand(*shape, N)
    x_lo = torch.gather(xs, -1, lo.expand(shape).to(torch.int64)[..., None])[..., 0]
    x_hi = torch.gather(xs, -1, hi.expand(shape).to(torch.int64)[..., None])[..., 0]
    # the last valid entry where hi would step past n_valid − 1
    x_hi = torch.where(hi.to(torch.float32) > last, x_lo, x_hi)
    return x_lo * (1.0 - frac) + x_hi * frac


def masked_quantile(x: torch.Tensor, mask: torch.Tensor, q) -> torch.Tensor:
    """np.quantile(x[mask], q) for each batch row, fixed-shape.

    x, mask: [..., N]; q: a scalar or a 1-D [Q] vector, the same set for
    every row, appended as a trailing axis. Rows with no valid entry give
    0.0 (the reference's ``quantile_safe`` convention)."""
    x_sorted = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))), dim=-1).values
    n_valid = mask.sum(dim=-1)
    q = torch.as_tensor(q, dtype=torch.float32, device=x.device)
    if q.ndim > 1:
        raise ValueError(f"masked_quantile supports scalar or 1-D q, got shape {tuple(q.shape)}")
    if q.ndim == 0:
        out = quantile_sorted(x_sorted, q, n_valid)
        return torch.where(n_valid > 0, out, torch.zeros_like(out))
    out = torch.stack([quantile_sorted(x_sorted, qq, n_valid) for qq in q], dim=-1)
    return torch.where((n_valid > 0)[..., None], out, torch.zeros_like(out))
