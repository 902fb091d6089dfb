"""Sharded batch encode and the sharded moments of the detector fits — the
port of ``anuraxla/parallel/encode.py``.

The wav -> mel -> latent path runs on every data shard of a mesh, each on
its slice of the batch with its own replica of the encoder; the pooled LDA
covariance and the distance histogram take per-shard sums reduced with
``psum`` (``parallel.mesh``), never gathering the latents onto one device.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict

import torch

from anuraxla_torch.constants import MelConfig
from anuraxla_torch.ops.frontend import log_mel_batch, mel_to_encoder_input
from anuraxla_torch.parallel.mesh import Mesh, batch_sharded, psum, shard_along
from anuraxla_torch.utils.precision import exact_f32


def replicate(module: torch.nn.Module, mesh: Mesh) -> Dict[torch.device, torch.nn.Module]:
    """One copy of ``module`` on each distinct data-shard device of ``mesh``
    (the module itself on the device it lives on)."""
    home = next(module.parameters()).device
    return {d: module if d == home else copy.deepcopy(module).to(d) for d in dict.fromkeys(mesh.data_devices)}


def make_sharded_encode(
    mesh: Mesh,
    encoder: torch.nn.Module,
    mel: MelConfig,
    *,
    parity: bool = True,
    backend: str = "cuda",
) -> Callable:
    """-> encode(audio [B, L]) -> latents [B, D] with the batch split over
    the data shards, each shard's log-mel and forward on its device with an
    encoder replica. B must divide by the data axis. A torch module carries
    its weights, so they are bound here (JAX's version takes params per
    call)."""
    replicas = replicate(encoder, mesh)

    def shard(i: int, audio) -> torch.Tensor:
        dev = mesh.data_devices[i]
        with torch.inference_mode():
            mels = log_mel_batch(torch.as_tensor(audio).to(dev), mel, parity=parity, backend=backend)
            return replicas[dev](mel_to_encoder_input(mels))["mu"]

    return batch_sharded(shard, mesh)


def sharded_pooled_cov(mesh: Mesh) -> Callable:
    """cov over per-class-centred latents split over the data shards:
    per-shard Gram matrices (TF32 off) + ``psum``, never materializing the
    gathered matrix on one device. Inputs: Zc [N, D] (already centred),
    mask [N]. Returns (cov [D, D], n_total)."""

    def cov(Zc, mask):
        grams, ns = [], []
        for z, m in zip(shard_along(Zc, mesh, dtype=torch.float32), shard_along(mask, mesh, dtype=torch.bool)):
            w = m.to(z.dtype)
            zw = z * w[:, None]
            with exact_f32():
                grams.append(zw.T @ zw)
            ns.append(w.sum())
        gram, n = psum(grams, mesh), psum(ns, mesh)
        return gram / torch.clamp(n - 1.0, min=1.0), n

    return cov


def histogram_parts(d_parts, m_parts, lo: torch.Tensor, hi: torch.Tensor, n_bins: int, mesh: Mesh) -> torch.Tensor:
    """Per-row histograms of sharded pools, ``psum``'d: d, mask parts
    [K, N_shard]; lo, hi [K] -> counts [K, n_bins] (f32). A sample's bin is
    ``(d − lo) / max(hi − lo, 1e-12) · n_bins`` truncated toward zero and
    clipped, in f32 (clamped to [−1, n_bins] before the cast, so that no
    out-of-range value is cast to int)."""
    out = []
    for d, m in zip(d_parts, m_parts):
        lo_d, hi_d = lo.to(d.device), hi.to(d.device)
        scaled = (d - lo_d[:, None]) / torch.clamp(hi_d - lo_d, min=1e-12)[:, None] * n_bins
        idx = torch.clamp(torch.clamp(scaled, -1.0, float(n_bins)).to(torch.int64), 0, n_bins - 1)
        rows = torch.arange(d.shape[0], device=d.device)[:, None] * n_bins
        counts = torch.zeros(d.shape[0] * n_bins, dtype=torch.float32, device=d.device)
        # scatter-add: O(N + n_bins) memory, no [N, n_bins] one-hot
        counts.index_add_(0, (idx + rows).reshape(-1), m.to(torch.float32).reshape(-1))
        out.append(counts.view(d.shape[0], n_bins))
    return psum(out, mesh)


def sharded_distance_histogram(mesh: Mesh, n_bins: int = 8192) -> Callable:
    """Global distance-distribution summary over sharded samples: per-shard
    histograms ``psum``'d. Inputs: d [N] distances, mask [N], lo / hi
    scalars. Returns counts [n_bins]."""

    def hist(d, mask, lo, hi):
        dp = [x[None] for x in shard_along(d, mesh, dtype=torch.float32)]
        mp = [x[None] for x in shard_along(mask, mesh, dtype=torch.bool)]
        dev = mesh.devices[0]
        lo = torch.as_tensor(lo, dtype=torch.float32, device=dev).reshape(1)
        hi = torch.as_tensor(hi, dtype=torch.float32, device=dev).reshape(1)
        return histogram_parts(dp, mp, lo, hi, n_bins, mesh)[0]

    return hist
