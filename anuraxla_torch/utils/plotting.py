"""Benchmark plots — a copy of ``anuraxla/utils/plotting.py``: confusion
matrix (NO_DETECT last), per-class accuracy, per-class NO_DETECT rate and
global counts, the four PNGs the reference benchmarks emit
(``10_benchmark_folder_detection.py:205-275``). matplotlib is imported
when a plot is drawn; the folder benchmark treats plots as best-effort
(a host without matplotlib logs one line and writes the rest).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

NO_DETECT = "NO_DETECT"


def _confusion(rows: List[dict]):
    labels = sorted({r["true_species"] for r in rows} | {r["pred_species"] for r in rows})
    if NO_DETECT in labels:
        labels = [l for l in labels if l != NO_DETECT] + [NO_DETECT]
    idx = {l: i for i, l in enumerate(labels)}
    import numpy as np

    cm = np.zeros((len(labels), len(labels)), int)
    for r in rows:
        cm[idx[r["true_species"]], idx[r["pred_species"]]] += 1
    return labels, cm


def _apply_seaborn_style() -> None:
    """Optional seaborn styling, mirroring the reference's behavior: its
    benchmark plots call ``sns.set_theme()`` when seaborn is importable
    (``ref:10_benchmark_folder_detection.py:205-215``) and fall back to bare
    matplotlib otherwise; where seaborn is installed, the plots pick up the
    same theme the reference's would."""
    try:
        import seaborn as sns

        sns.set_theme(style="whitegrid")
    except Exception:
        pass


def write_benchmark_plots(rows: List[dict], out_dir: Path, *, map_variant: bool = False) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    _apply_seaborn_style()

    suffix = " — MAP" if map_variant else ""
    out_dir = Path(out_dir)

    # confusion matrix
    labels, cm = _confusion(rows)
    n = len(labels)
    plt.figure(figsize=(1 + 0.6 * n, 1 + 0.6 * n))
    plt.imshow(cm, aspect="auto", cmap="viridis")
    plt.colorbar()
    plt.xticks(range(n), labels, rotation=45, ha="right")
    plt.yticks(range(n), labels)
    cm_max = float(cm.max()) if cm.size else 1.0  # all-ERROR run: 0x0 matrix
    for i in range(n):
        for j in range(n):
            plt.text(j, i, str(cm[i, j]), ha="center", va="center", fontsize=8,
                     color="white" if cm[i, j] < cm_max * 0.6 else "black")
    plt.title(f"Confusion Matrix (includes NO_DETECT){suffix}")
    plt.xlabel("pred")
    plt.ylabel("true")
    plt.tight_layout()
    plt.savefig(out_dir / "confusion_matrix.png", dpi=150, bbox_inches="tight")
    plt.close()

    # per-class aggregates
    per: Dict[str, dict] = {}
    for r in rows:
        d = per.setdefault(r["true_species"], {"n": 0, "correct": 0, "no_detect": 0})
        d["n"] += 1
        d["correct"] += int(r["correct"])
        d["no_detect"] += int(r["pred_species"] == NO_DETECT)

    def barh(values: Dict[str, float], title: str, xlabel: str, fname: str):
        items = sorted(values.items(), key=lambda kv: -kv[1])
        names = [k for k, _ in items]
        vals = [v * 100.0 for _, v in items]
        plt.figure(figsize=(10, max(4, 0.35 * len(names))))
        plt.barh(names, vals)
        plt.xlabel(xlabel)
        plt.title(title)
        plt.xlim(0, 100)
        plt.gca().invert_yaxis()
        plt.tight_layout()
        plt.savefig(out_dir / fname, dpi=150, bbox_inches="tight")
        plt.close()

    barh(
        {sp: d["correct"] / d["n"] for sp, d in per.items() if d["n"]},
        f"Accuracy by species{suffix}", "Accuracy (%)", "accuracy_by_class.png",
    )
    barh(
        {sp: d["no_detect"] / d["n"] for sp, d in per.items() if d["n"]},
        f"NO_DETECT rate by species{suffix}", "NO_DETECT rate (%)", "no_detect_rate_by_class.png",
    )

    # global counts
    total = len(rows)
    correct = sum(r["correct"] for r in rows)
    wrong = total - correct
    no_det = sum(r["pred_species"] == NO_DETECT for r in rows)
    plt.figure(figsize=(8, 4))
    plt.bar(["Correct", "Wrong", "NO_DETECT"], [correct, wrong, no_det])
    plt.title(f"Global summary (N={total}){suffix}")
    plt.ylabel("Count")
    plt.tight_layout()
    plt.savefig(out_dir / "global_counts.png", dpi=150, bbox_inches="tight")
    plt.close()
