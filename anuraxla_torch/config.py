"""Read access to the ``config.json`` radial block — a copy of the parts of
``anuraxla/config.py`` the serving path needs (``get_chunk_seconds``,
``priority_ranks``, ``read_radial``, ``load_config``)."""

from __future__ import annotations

from collections import Counter
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np

from anuraxla_torch.constants import PRIORITY_ORDER
from anuraxla_torch.utils.io import load_json


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


def load_config(path: Path) -> Dict[str, Any]:
    return load_json(path)
