"""The comparison that decides ``correct``: the program's decisions against the
reference's, row by row.

- ``dist_gap``: the widest gap between the program's best distance and the
  reference's, over the median of the reference's best distances;
- ``decisions_flipped``: rows whose decision (detected, species) differs from
  the reference's although every species' distance in the reference lies
  farther from its radius than the ``dist_gap`` limit allows the program to
  move it (a flip closer to a radius is the gap's to judge);
- ``rows_missing``: rows due that the program did not answer, or answered as
  failed.
"""

from __future__ import annotations

import numpy as np


def compare(best_p: np.ndarray, winner_p: np.ndarray, detected_p: np.ndarray, missing: int,
            d_ref: np.ndarray, thresholds: np.ndarray, gap_limit: float) -> dict:
    """Program rows (best distance, winner index or -1, detected) against the
    reference's [N, K] distances. -> {name: value}."""
    from perfbench.reference.radial import decide

    det_r, win_r, best_r = decide(d_ref, thresholds)
    scale = float(np.median(best_r))
    diff = np.abs(np.asarray(best_p, np.float64) - best_r)
    gap = float(np.max(diff) / scale) if diff.size else 0.0
    if not np.isfinite(gap):
        gap = float("inf")  # a distance the program answered as NaN or inf is as far off as can be
    margin = np.min(np.abs(d_ref - np.asarray(thresholds, np.float64)[None]), axis=1) / scale
    firm = margin > gap_limit
    differs = (np.asarray(detected_p, bool) != det_r) | (np.asarray(winner_p) != win_r)
    return {"dist_gap": gap, "decisions_flipped": int((firm & differs).sum()), "rows_missing": int(missing),
            "flip_margin": float(margin[differs].max()) if differs.any() else 0.0,
            "detected_share": float(det_r.mean()) if det_r.size else 0.0}
