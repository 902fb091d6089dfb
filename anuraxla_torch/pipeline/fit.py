"""Fit orchestration — the port of ``anuraxla/pipeline/fit.py``
(``encode_augmented_tree``, ``fit_radial_tree``, ``fit_map_tree``): encode a
labelled species tree, fit a detector on the session's device, and write the
reference's ``config.json`` block. Shared by the fit-radial and fit-map CLIs
and the calibration grid.

A data-parallel session keeps the fit sample-sharded (``parallel.fit``) over
the shards of every process (``_fit_mesh``), where there are several — the
session's own mesh is this process's alone; otherwise the fit runs on the
session's device.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from anuraxla_torch import config as cfgmod
from anuraxla_torch.detect.gaussian_map import fit_map, true_class_score_summary
from anuraxla_torch.detect.radial import fit_radial
from anuraxla_torch.ops.quantiles import quantile_sorted
from anuraxla_torch.parallel.fit import fit_map_sharded, fit_radial_sharded
from anuraxla_torch.parallel.mesh import Mesh, make_mesh
from anuraxla_torch.pipeline.session import EncoderSession, encode_species_tree, pad_species_latents


def _f(x) -> float:
    return float(np.asarray(x))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _fit_mesh(session: EncoderSession) -> Optional[Mesh]:
    """The mesh a data-parallel session's fits shard over: every shard of
    every process (``make_mesh``), where there are several; else None."""
    if not session.data_parallel:
        return None
    mesh = make_mesh(device=session.dev)
    return mesh if mesh.shape["data"] > 1 else None


def _use_sharded_fit(session: EncoderSession) -> bool:
    """Data-parallel sessions over several shards keep the fit sample-sharded
    over the mesh (latents never gather onto one device: parallel.fit)."""
    return _fit_mesh(session) is not None


def _fit_radial_dispatch(session, Z, mask, q_in, q_out):
    mesh = _fit_mesh(session)
    if mesh is not None:
        return fit_radial_sharded(Z, mask, q_in, q_out, mesh=mesh)
    dev = session.dev
    return fit_radial(torch.from_numpy(Z).to(dev), torch.from_numpy(mask).to(dev), q_in, q_out)


def _fit_map_dispatch(session, Z, mask, **kw):
    mesh = _fit_mesh(session)
    if mesh is not None:
        return fit_map_sharded(Z, mask, mesh=mesh, **kw)
    dev = session.dev
    return fit_map(torch.from_numpy(Z).to(dev), torch.from_numpy(mask).to(dev), **kw)


def encode_augmented_tree(
    session: EncoderSession,
    chunks_dir: Path,
    species_all,
    *,
    augment_noise_db,
    cache: bool,
    cache_dir: Optional[Path],
    max_per_class: int,
    seed: int,
    log=print,
):
    """Clean encode plus one noised encode per SNR in ``augment_noise_db``,
    concatenated per species, so thresholds and covariances absorb the latent
    shift noise causes. Each noised leg replays the clean leg's subsampling
    (same seed) and caches under its own ``_nz<db>`` suffix."""
    Z_by, failed, used = encode_species_tree(
        session, chunks_dir, species_all,
        cache=cache, cache_dir=cache_dir, max_per_class=max_per_class, seed=seed, log=log,
    )
    for db in augment_noise_db or ():
        session.add_noise_db = float(db)
        try:
            log(f"🌫️ augment: re-encoding at {db:g} dB SNR")
            Zn, f2, u2 = encode_species_tree(
                session, chunks_dir, species_all,
                cache=cache, cache_dir=cache_dir, max_per_class=max_per_class,
                seed=seed, cache_tag=f"_nz{db:g}", log=log,
            )
        finally:
            session.add_noise_db = None
        for sp, Zn_sp in Zn.items():
            Z_by[sp] = np.concatenate([Z_by[sp], Zn_sp]) if sp in Z_by else Zn_sp
            failed[sp] = failed.get(sp, 0) + f2.get(sp, 0)
            used[sp] = used.get(sp, 0) + u2.get(sp, 0)
    return Z_by, failed, used


def fit_radial_tree(
    *,
    cfg_path: Path,
    cfg: Dict[str, Any],
    chunks_dir: Path,
    session: EncoderSession,
    q_in: float,
    q_out: float,
    cache: bool,
    cache_dir: Optional[Path],
    max_per_class: int,
    seed: int,
    augment_noise_db=None,
    log=print,
) -> Dict[str, Any]:
    """Encode -> radial fit on the session's device -> write the
    radial_detector block. Returns the fitted per-species numbers, also
    printed as the ✅ rk lines that the snapshot tool parses."""
    species_all = cfgmod.require_species(cfg)
    Z_by, failed, used = encode_augmented_tree(
        session, chunks_dir, species_all, augment_noise_db=augment_noise_db,
        cache=cache, cache_dir=cache_dir, max_per_class=max_per_class, seed=seed, log=log,
    )
    if not Z_by:
        raise SystemExit("❌ no species could be encoded — check --root and the pipeline.")

    species, Z, mask = pad_species_latents(Z_by)
    fit = _fit_radial_dispatch(session, Z, mask, q_in, q_out)

    # rho summaries from the fit's sorted distance pools (no host recompute)
    def pool_summary(sorted_pool: torch.Tensor, n_valid: torch.Tensor):
        qs = _np(torch.stack([quantile_sorted(sorted_pool, q, n_valid) for q in (0.5, 0.9)]))  # [2, K]
        sp_arr, n = _np(sorted_pool), _np(n_valid).astype(int)
        empty = n == 0
        last = np.clip(n - 1, 0, sp_arr.shape[1] - 1)
        return {
            "min": np.where(empty, np.nan, sp_arr[:, 0]),
            "p50": np.where(empty, np.nan, qs[0]),
            "p90": np.where(empty, np.nan, qs[1]),
            "max": np.where(empty, np.nan, sp_arr[np.arange(sp_arr.shape[0]), last]),
        }

    in_summary = pool_summary(fit.rho_in_sorted, fit.n_in)
    out_summary = pool_summary(fit.rho_out_sorted, fit.n_out)

    rk_in, rk_out, rk = _np(fit.rk_in), _np(fit.rk_out), _np(fit.rk)
    n_in, n_out = _np(fit.n_in), _np(fit.n_out)
    meta: Dict[str, Dict[str, Any]] = {}
    for i, sp in enumerate(species):
        out_finite = math.isfinite(_f(rk_out[i]))
        meta[sp] = {
            "N_in": int(n_in[i]),
            "N_out": int(n_out[i]),
            "rk_in": _f(rk_in[i]),
            "rk_out": _f(rk_out[i]) if out_finite else None,
            "rk_final": _f(rk[i]),
            "failed": int(failed.get(sp, 0)),
            "used": int(used.get(sp, n_in[i])),
            "rho_in_summary": {k: _f(v[i]) for k, v in in_summary.items()},
            "rho_out_summary": {k: _f(v[i]) for k, v in out_summary.items()},
        }
        rk_out_print = _f(rk_out[i]) if out_finite else float("nan")
        # exact line format consumed by the snapshot-from-log regex (9105:11-13)
        log(f"✅ {sp}: rk_in={_f(rk_in[i]):.6f} | rk_out={rk_out_print:.6f} | rk={_f(rk[i]):.6f}")
        log(f"   rho_in:  {meta[sp]['rho_in_summary']}")
        log(f"   rho_out: {meta[sp]['rho_out_summary']}")

    backup = cfgmod.write_radial(
        cfg_path, cfg, species, _np(fit.centroids), rk,
        chunks_dir=chunks_dir, mel=session.mel, q_in=q_in, q_out=q_out,
        max_per_class=max_per_class, seed=seed, per_species_meta=meta,
        augment_noise_db=augment_noise_db,
    )
    log(f"\n💾 saved: {cfg_path}")
    log(f"🗂️ backup: {backup}")
    return {"species": species, "rk": rk, "rk_in": rk_in, "rk_out": rk_out, "meta": meta, "fit": fit,
            "Z": Z, "mask": mask}


def fit_map_tree(
    *,
    cfg_path: Path,
    cfg: Dict[str, Any],
    chunks_dir: Path,
    session: EncoderSession,
    cov_type: str,
    cov_structure: str,
    priors_mode: str,
    eps: float,
    shrink: float,
    tau_q: Optional[float],
    cache: bool,
    cache_dir: Optional[Path],
    max_per_class: int,
    seed: int,
    augment_noise_db=None,
    log=print,
) -> Dict[str, Any]:
    """Encode -> MAP fit on the session's device -> write the map_detector
    block."""
    species_all = cfgmod.require_species(cfg)
    Z_by, failed, used = encode_augmented_tree(
        session, chunks_dir, species_all, augment_noise_db=augment_noise_db,
        cache=cache, cache_dir=cache_dir, max_per_class=max_per_class, seed=seed, log=log,
    )
    if not Z_by:
        raise SystemExit("❌ no species could be encoded — check --root and the pipeline.")

    # the reference fits over sorted(species_present) (08b:258)
    Z_by = {sp: Z_by[sp] for sp in sorted(Z_by)}
    species, Z, mask = pad_species_latents(Z_by)
    # D >> n guard: a FULL pooled covariance from fewer samples than latent
    # dims is rank-deficient and a tau fit on it rejects everything
    D = Z.shape[2]
    min_n = int(mask.sum(1).min())
    if cov_structure == "full" and min_n < D and shrink < 0.05:
        log(
            f"⚠️ small-n regime: min class size {min_n} < latent dim {D} with "
            f"cov_structure=full and shrink={shrink}. The fitted detector will "
            "likely reject every input once tau is set. Use `--preset small-n` "
            "(diag + shrink 0.1) or raise --shrink/--eps."
        )
    fit = _fit_map_dispatch(session, Z, mask, cov_type=cov_type, cov_structure=cov_structure,
                            priors_mode=priors_mode, eps=eps, shrink=shrink, tau_q=tau_q)
    dev = fit.means.device
    Zt, mt = torch.from_numpy(Z).to(dev), torch.from_numpy(mask).to(dev)

    summaries = {k: _np(v) for k, v in true_class_score_summary(fit, Zt, mt).items()}
    n_k = mask.sum(1)
    priors = _np(fit.priors)
    per_meta: Dict[str, Dict[str, Any]] = {}
    for i, sp in enumerate(species):
        per_meta[sp] = {
            "N": int(n_k[i]),
            "failed": int(failed.get(sp, 0)),
            "used": int(used.get(sp, n_k[i])),
            "prior": _f(priors[i]),
            "score_true_summary": {k: _f(v[i]) for k, v in summaries.items()},
        }

    n_scores = int(fit.n_scores)
    valid_scores = _np(fit.scores_true_sorted)[:n_scores]
    global_summary = {
        "min": _f(valid_scores.min()) if n_scores else float("nan"),
        "p05": _f(np.quantile(valid_scores, 0.05)) if n_scores else float("nan"),
        "p50": _f(np.quantile(valid_scores, 0.50)) if n_scores else float("nan"),
        "p95": _f(np.quantile(valid_scores, 0.95)) if n_scores else float("nan"),
        "max": _f(valid_scores.max()) if n_scores else float("nan"),
    }

    tau_val = None if tau_q is None else _f(_np(fit.tau))
    if tau_val is not None:
        log(f"\n✅ tau from train: tau = quantile(score_true_class, q={tau_q}) = {tau_val:.6f}")

    backup = cfgmod.write_map(
        cfg_path, cfg, species,
        _np(fit.means), _np(fit.covs), _np(fit.precisions), _np(fit.logdets), priors, tau_val,
        cov_type=cov_type, cov_structure=cov_structure, priors_mode=priors_mode,
        chunks_dir=chunks_dir, mel=session.mel, max_per_class=max_per_class, seed=seed,
        eps=eps, shrink=shrink, tau_q=tau_q,
        score_true_global_summary=global_summary, per_species_meta=per_meta,
        augment_noise_db=augment_noise_db,
    )
    log(f"\n💾 saved: {cfg_path}")
    log(f"🗂️ backup: {backup}")
    log("\n✅ MAP detector fit done. (NO_DETECT is decided via tau at evaluation.)")
    return {"species": species, "fit": fit, "meta": per_meta, "Z": Z, "mask": mask}
