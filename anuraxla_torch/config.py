"""The ``config.json`` artifact schema — a copy of ``anuraxla/config.py``
(``require_species``, ``get_chunk_seconds``, ``priority_ranks``,
``read_radial``, ``write_radial``, ``read_map``, ``write_map``,
``load_config``), so that either package reads the blocks the other writes:

- ``radial_detector.{centroids, thresholds, meta_fit}``;
- ``map_detector.{model, cov_type, cov_structure, priors, means, cov,
  precision, logdet_cov, tau, meta_fit}``;
- the required keys ``species`` (list) and ``chunk_seconds``.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from anuraxla_torch.constants import PRIORITY_ORDER, MelConfig
from anuraxla_torch.utils.io import load_json, save_json_with_backup


def require_species(cfg: Dict[str, Any]) -> List[str]:
    sp = cfg.get("species")
    if not isinstance(sp, list) or not all(isinstance(s, str) for s in sp):
        raise SystemExit("❌ config.json must contain 'species' (list of strings).")
    return sp


def get_chunk_seconds(cfg: Dict[str, Any], default: float = 5.0) -> float:
    try:
        return float(cfg.get("chunk_seconds", default))
    except (TypeError, ValueError):
        return default


def priority_ranks(species: List[str]) -> np.ndarray:
    """Rank array for tie-breaking: position in PRIORITY_ORDER for known
    species; unknown species come after, ordered lexicographically (the
    reference's sorted(accepted)[0] fallback, ``09:431-436``)."""
    known = {sp: i for i, sp in enumerate(PRIORITY_ORDER)}
    extra = sorted(s for s in species if s not in known)
    ranks = [
        float(known[s]) if s in known else float(len(PRIORITY_ORDER) + extra.index(s))
        for s in species
    ]
    return np.asarray(ranks, np.float32)


def _mel_meta(mel: MelConfig) -> Dict[str, Any]:
    return {
        "chunk_seconds": float(mel.duration),
        "sr": int(mel.sr),
        "n_mels": int(mel.n_mels),
        "target_frames": int(mel.target_frames),
        "fmin": float(mel.fmin),
        "fmax": float(mel.fmax),
        "hop_length": int(mel.hop_length),
        "n_fft": int(mel.n_fft),
    }


def read_radial(cfg: Dict[str, Any]) -> Tuple[List[str], np.ndarray, np.ndarray, float]:
    """-> (species, centroids [K, D], thresholds [K], chunk_seconds)."""
    rd = cfg.get("radial_detector")
    if not isinstance(rd, dict):
        raise ValueError(
            "config.json has no radial_detector block. Run the radial fit first "
            "(anuraxla fit-radial / 08_fit_radial_detector equivalent)."
        )
    cent, thr = rd.get("centroids"), rd.get("thresholds")
    if not isinstance(cent, dict) or not isinstance(thr, dict):
        raise ValueError("radial_detector must contain 'centroids' and 'thresholds' dicts.")

    species = [sp for sp in cent if isinstance(cent[sp], list) and cent[sp] and sp in thr]
    if not species:
        raise ValueError("radial_detector centroids/thresholds empty or malformed.")
    dims = {len(cent[sp]) for sp in species}
    if len(dims) != 1:
        # keep only the majority dimension (the reference skips mismatched
        # species at decide time, 09:421)
        d = Counter(len(cent[sp]) for sp in species).most_common(1)[0][0]
        species = [sp for sp in species if len(cent[sp]) == d]
    centroids = np.asarray([cent[sp] for sp in species], np.float32)
    thresholds = np.asarray([float(thr[sp]) for sp in species], np.float32)
    return species, centroids, thresholds, get_chunk_seconds(cfg)


def write_radial(
    cfg_path: Path,
    cfg: Dict[str, Any],
    species: List[str],
    centroids: np.ndarray,
    rk: np.ndarray,
    *,
    chunks_dir: Path,
    mel: MelConfig,
    q_in: float,
    q_out: float,
    max_per_class: int,
    seed: int,
    per_species_meta: Dict[str, Dict[str, Any]],
    augment_noise_db=None,
) -> Path:
    """Write the radial_detector block with a .bak backup, keeping every
    other config key. -> the backup's path."""
    rd = cfg.setdefault("radial_detector", {})
    if not isinstance(rd, dict):
        rd = cfg["radial_detector"] = {}
    rd["centroids"] = {sp: [float(v) for v in centroids[i]] for i, sp in enumerate(species)}
    rd["thresholds"] = {sp: float(rk[i]) for i, sp in enumerate(species)}
    rd["meta_fit"] = {
        "chunks_dir": str(chunks_dir),
        "chunks_name": Path(chunks_dir).name,
        "q_in": float(q_in),
        "q_out": float(q_out),
        **_mel_meta(mel),
        "max_per_class": int(max_per_class),
        "seed": int(seed),
        "per_species": per_species_meta,
        **({"augment_noise_db": [float(d) for d in augment_noise_db]} if augment_noise_db else {}),
    }
    return save_json_with_backup(cfg_path, cfg)


def read_map(cfg: Dict[str, Any]) -> Tuple[
    List[str], np.ndarray, np.ndarray, np.ndarray, np.ndarray, Optional[float], float
]:
    """-> (species, means [K, D], precisions [K, D, D], logdets [K], priors
    [K], tau | None, chunk_seconds). Priors: meta_fit.per_species[sp].prior
    when every species has one (clamped >= 0 and renormalized), else
    uniform; chunk_seconds: the map meta's, else the global one."""
    md = cfg.get("map_detector")
    if not isinstance(md, dict):
        raise ValueError(
            "config.json has no map_detector block. Run the MAP fit first "
            "(anuraxla fit-map / 08b_fit_map_detector equivalent)."
        )
    if md.get("model", "") != "gaussian_map":
        raise ValueError(f"unexpected map_detector.model: {md.get('model')!r}")

    means_raw, prec_raw, ld_raw = md.get("means"), md.get("precision"), md.get("logdet_cov")
    if not all(isinstance(x, dict) for x in (means_raw, prec_raw, ld_raw)):
        raise ValueError("map_detector must contain 'means', 'precision', 'logdet_cov' dicts.")

    species = sorted(set(means_raw) & set(prec_raw) & set(ld_raw))
    species = [sp for sp in species if isinstance(means_raw[sp], list) and means_raw[sp]]
    if not species:
        raise ValueError("map_detector means/precision/logdet_cov empty or inconsistent.")
    # majority dimension, as read_radial: one malformed entry must not
    # discard every healthy detector just by sorting first
    d = Counter(len(means_raw[sp]) for sp in species).most_common(1)[0][0]

    def _square(sp) -> bool:
        p = prec_raw[sp]
        return isinstance(p, list) and len(p) == d and all(isinstance(r, list) and len(r) == d for r in p)

    species = [sp for sp in species if len(means_raw[sp]) == d and _square(sp)]
    if not species:
        raise ValueError("map_detector: no species with consistent [D]/[D,D] shapes.")

    means = np.asarray([means_raw[sp] for sp in species], np.float32)
    precs = np.asarray([prec_raw[sp] for sp in species], np.float32)
    lds = np.asarray([float(ld_raw[sp]) for sp in species], np.float32)

    per = (md.get("meta_fit") or {}).get("per_species") or {}
    try:
        priors_list = [float(per[sp]["prior"]) for sp in species]
    except (KeyError, TypeError, ValueError):
        priors_list = []
    if priors_list:
        p = np.maximum(np.asarray(priors_list, np.float64), 0.0)
        s = p.sum()
        priors = (p / s if s > 0 else np.full(len(species), 1.0 / len(species))).astype(np.float32)
    else:
        priors = np.full(len(species), 1.0 / len(species), np.float32)

    tau = md.get("tau")
    tau_f = float(tau) if tau is not None else None
    meta = md.get("meta_fit") or {}
    try:
        chunk_seconds = float(meta["chunk_seconds"])
    except (KeyError, TypeError, ValueError):
        chunk_seconds = get_chunk_seconds(cfg)
    return species, means, precs, lds, priors, tau_f, chunk_seconds


def write_map(
    cfg_path: Path,
    cfg: Dict[str, Any],
    species: List[str],
    means: np.ndarray,
    covs: np.ndarray,
    precisions: np.ndarray,
    logdets: np.ndarray,
    priors: np.ndarray,
    tau: Optional[float],
    *,
    cov_type: str,
    cov_structure: str,
    priors_mode: str,
    chunks_dir: Path,
    mel: MelConfig,
    max_per_class: int,
    seed: int,
    eps: float,
    shrink: float,
    tau_q: Optional[float],
    score_true_global_summary: Dict[str, float],
    per_species_meta: Dict[str, Dict[str, Any]],
    augment_noise_db=None,
) -> Path:
    """Write the map_detector block with a .bak backup. -> the backup's path."""
    cfg["map_detector"] = {
        "model": "gaussian_map",
        "cov_type": str(cov_type),
        "cov_structure": str(cov_structure),
        "priors": str(priors_mode),
        "means": {sp: [float(v) for v in means[i]] for i, sp in enumerate(species)},
        "cov": {sp: covs[i].astype(float).tolist() for i, sp in enumerate(species)},
        "precision": {sp: precisions[i].astype(float).tolist() for i, sp in enumerate(species)},
        "logdet_cov": {sp: float(logdets[i]) for i, sp in enumerate(species)},
        "tau": (float(tau) if tau is not None else None),
        "meta_fit": {
            "chunks_dir": str(chunks_dir),
            "chunks_name": Path(chunks_dir).name,
            **_mel_meta(mel),
            "max_per_class": int(max_per_class),
            "seed": int(seed),
            "eps": float(eps),
            "shrink": float(shrink),
            "tau_from_train_quantile": (float(tau_q) if tau_q is not None else None),
            "score_true_global_summary": score_true_global_summary,
            "per_species": per_species_meta,
            **({"augment_noise_db": [float(d) for d in augment_noise_db]} if augment_noise_db else {}),
        },
    }
    return save_json_with_backup(cfg_path, cfg)


def load_config(path: Path) -> Dict[str, Any]:
    return load_json(path)
