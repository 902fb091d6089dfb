"""``spearman-analysis`` on the port — a copy of
``anuraxla/cli/spearman_analysis.py``: Spearman correlations over a q_out
grid (reference ``9100_spearman_rk_analysis.py``). Parses each run dir's
summary.txt + config_snapshot.json, correlates q_out vs global ACC/NO_DETECT
and, per species, rk vs acc / rk vs no_detect / q_out vs rk; writes
spearman_table.csv into the grid dir.

    python -m anuraxla_torch spearman-analysis --grid-dir outputs/qout_grid_20260101
"""

from __future__ import annotations

import argparse
import csv
import json
import re
from pathlib import Path
from typing import Dict, List, Tuple

SUMMARY_GLOBAL_RE = re.compile(r"Correct:\s*\d+\s*\|\s*Accuracy:\s*([0-9.]+)%")
SUMMARY_NODET_RE = re.compile(r"NO_DETECT:\s*\d+\s*\|\s*Rate:\s*([0-9.]+)%")
SUMMARY_CLASS_RE = re.compile(
    r"^\-\s*(?P<sp>.+?)\s+n=\s*(?P<n>\d+)\s+acc=\s*(?P<acc>[0-9.]+)%\s+no_detect=\s*(?P<nd>[0-9.]+)%",
    re.IGNORECASE,
)


def parse_summary(path: Path) -> Tuple[float, float, Dict[str, float], Dict[str, float]]:
    acc_g = nd_g = None
    acc_sp: Dict[str, float] = {}
    nd_sp: Dict[str, float] = {}
    for line in path.read_text(encoding="utf-8", errors="replace").splitlines():
        if m := SUMMARY_GLOBAL_RE.search(line):
            acc_g = float(m.group(1)) / 100.0
        if m := SUMMARY_NODET_RE.search(line):
            nd_g = float(m.group(1)) / 100.0
        if m := SUMMARY_CLASS_RE.match(line.strip()):
            acc_sp[m.group("sp").strip()] = float(m.group("acc")) / 100.0
            nd_sp[m.group("sp").strip()] = float(m.group("nd")) / 100.0
    if acc_g is None or nd_g is None:
        raise RuntimeError(f"could not parse global ACC/NO_DETECT from {path}")
    return acc_g, nd_g, acc_sp, nd_sp


def spearman_safe(x: List[float], y: List[float]) -> Tuple[float, float, str]:
    """Spearman rho with explicit degenerate-case handling.

    Returns (rho, p, note). A constant series has no rank ordering, so the
    correlation is UNDEFINED — detect it up front and return an explicit
    (nan, nan, reason) instead of letting scipy raise ConstantInputWarning
    and hand back a silent NaN (the reference's 9100 script :120-130 returns
    that NaN without a reason).
    """
    if len(x) < 3 or len(y) < 3:
        return float("nan"), float("nan"), f"insufficient points (n={len(x)})"
    const = [name for name, v in (("x", x), ("y", y)) if min(v) == max(v)]
    if const:
        return (
            float("nan"),
            float("nan"),
            f"undefined: constant input ({' and '.join(const)})",
        )
    try:
        from scipy.stats import spearmanr

        rho, p = spearmanr(x, y)
        return (
            float(rho) if rho is not None else float("nan"),
            float(p) if p is not None else float("nan"),
            "",
        )
    except Exception as e:
        return float("nan"), float("nan"), f"scipy error: {type(e).__name__}"


def analyze_grid(grid_dir: Path, log=print) -> List[dict]:
    run_dirs = sorted(d for d in grid_dir.iterdir() if d.is_dir() and d.name.startswith("qout_"))
    if not run_dirs:
        raise RuntimeError(f"no qout_* dirs in {grid_dir}")

    records = []
    for d in run_dirs:
        summary, snap = d / "summary.txt", d / "config_snapshot.json"
        if not summary.exists() or not snap.exists():
            log(f"⚠️ skipping {d.name} (missing summary/snapshot)")
            continue
        acc_g, nd_g, acc_sp, nd_sp = parse_summary(summary)
        s = json.loads(snap.read_text())
        records.append({
            "q_out": float(s["q_out"]),
            "acc_g": acc_g, "nd_g": nd_g,
            "acc_sp": acc_sp, "nd_sp": nd_sp,
            "rk": {k: float(v) for k, v in (s.get("rk_per_species") or {}).items()},
        })
    if not records:
        raise RuntimeError("no parsable runs")
    records.sort(key=lambda r: r["q_out"])

    qouts = [r["q_out"] for r in records]
    rho_nd, p_nd, note_nd = spearman_safe(qouts, [r["nd_g"] for r in records])
    rho_acc, p_acc, note_acc = spearman_safe(qouts, [r["acc_g"] for r in records])

    def _fmt(rho: float, p: float, note: str) -> str:
        return f"n/a ({note})" if note else f"{rho: .3f} (p={p: .4f})"

    log("\n📊 SPEARMAN CORRELATIONS")
    log(f"GLOBAL corr(q_out, NO_DETECT) = {_fmt(rho_nd, p_nd, note_nd)}")
    log(f"GLOBAL corr(q_out, ACC)       = {_fmt(rho_acc, p_acc, note_acc)}")

    rows = [
        {"scope": "GLOBAL", "species": "", "x": "q_out", "y": "NO_DETECT_global",
         "rho": rho_nd, "p": p_nd, "n_points": len(qouts), "note": note_nd},
        {"scope": "GLOBAL", "species": "", "x": "q_out", "y": "ACC_global",
         "rho": rho_acc, "p": p_acc, "n_points": len(qouts), "note": note_acc},
    ]

    species = sorted({sp for r in records for sp in r["rk"]} | {sp for r in records for sp in r["acc_sp"]})
    for sp in species:
        xs, ya, yn, xq = [], [], [], []
        for r in records:
            if sp in r["rk"] and sp in r["acc_sp"] and sp in r["nd_sp"]:
                xs.append(r["rk"][sp])
                ya.append(r["acc_sp"][sp])
                yn.append(r["nd_sp"][sp])
                xq.append(r["q_out"])
        if len(xs) < 3:
            log(f"- {sp}: insufficient points (n={len(xs)})")
            continue
        for x, y, xn, yn_name, vals in [
            (xs, ya, "rk", "ACC", None),
            (xs, yn, "rk", "NO_DETECT", None),
            (xq, xs, "q_out", "rk", None),
        ]:
            rho, p, note = spearman_safe(x, y)
            rows.append({"scope": "PER_CLASS", "species": sp, "x": xn, "y": yn_name,
                         "rho": rho, "p": p, "n_points": len(x), "note": note})

        def _cell(r: dict) -> str:
            return "n/a" if r["note"] else f"{r['rho']: .3f}"

        log(f"- {sp}: corr(rk,ACC)={_cell(rows[-3])} corr(rk,ND)={_cell(rows[-2])} corr(q,rk)={_cell(rows[-1])}")

    out_csv = grid_dir / "spearman_table.csv"
    with open(out_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=["scope", "species", "x", "y", "rho", "p", "n_points", "note"])
        w.writeheader()
        w.writerows(rows)
    log(f"\n✅ table: {out_csv}")
    return rows


def _latest_grid_dir() -> Path | None:
    """Default like the reference's dated-dir convention: the newest
    outputs/qout_grid_* under the project root."""
    from anuraxla_torch.utils.io import find_project_root

    root = find_project_root(Path.cwd())
    cands = sorted((root / "outputs").glob("qout_grid_*")) if (root / "outputs").exists() else []
    return cands[-1] if cands else None


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--grid-dir", type=str, default=None,
                   help="default: newest outputs/qout_grid_* under the project root")
    args = p.parse_args(argv)
    grid_dir = Path(args.grid_dir).expanduser().resolve() if args.grid_dir else _latest_grid_dir()
    if grid_dir is None or not grid_dir.exists():
        raise SystemExit(f"❌ grid dir not found: {grid_dir or '(no outputs/qout_grid_* found)'}")
    analyze_grid(grid_dir)


if __name__ == "__main__":
    main()
