"""Plain radial detector: per-species centroid and radius, accept species k
when ||z - c_k|| <= r_k, the first accepted species in priority order wins,
and the best distance is the smallest over all species. Distances in float64."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def distances(Z: torch.Tensor, centroids: np.ndarray) -> np.ndarray:
    """[N, D] latents, [K, D] centroids -> [N, K] float64."""
    z = Z.detach().double().cpu().numpy()
    c = np.asarray(centroids, np.float64)
    return np.sqrt(np.maximum(((z[:, None, :] - c[None]) ** 2).sum(-1), 0.0))


def decide(d: np.ndarray, thresholds: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (detected [N], winner [N] species index in priority order or -1, best [N])."""
    acc = d <= np.asarray(thresholds, np.float64)[None]
    detected = acc.any(1)
    winner = np.where(detected, np.argmax(acc, axis=1), -1)
    return detected, winner, d.min(1)


def fit(Z: np.ndarray, labels: np.ndarray, n_species: int, q: float) -> Tuple[np.ndarray, np.ndarray]:
    """Centroid = the species' mean latent; radius = the ``q`` quantile of its
    own latents' distances to it."""
    cents = np.stack([Z[labels == k].mean(0) for k in range(n_species)])
    thr = np.array([np.quantile(np.linalg.norm(Z[labels == k] - cents[k], axis=1), q) for k in range(n_species)])
    return cents.astype(np.float32), thr.astype(np.float32)


def config_block(species: Sequence[str], cents: np.ndarray, thr: np.ndarray, chunk_seconds: float) -> dict:
    """A ``config.json`` with ``species``, ``chunk_seconds`` and a ``radial_detector`` block."""
    return {
        "species": list(species),
        "chunk_seconds": float(chunk_seconds),
        "radial_detector": {
            "centroids": {sp: [float(v) for v in cents[i]] for i, sp in enumerate(species)},
            "thresholds": {sp: float(thr[i]) for i, sp in enumerate(species)},
        },
    }
