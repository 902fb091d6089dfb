"""``print-latents`` on the port — a copy of ``anuraxla/cli/print_latents.py``
(the port imports nothing of ``anuraxla``). A ``.parquet`` table needs
``pandas``; where it does not import, only ``.npz`` caches are read.

Print raw latent vectors from a features .parquet
(reference ``06_print_latent_coords.py``: auto-detects a label column, prints
the first N rows as text or JSONL). Also accepts the .npz latent caches this
framework writes, which the reference tool could not read.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

LABEL_CANDIDATES = ["label", "class", "category", "group", "filename", "file", "path", "id", "uid", "name"]


def load_table(path: Path) -> Tuple[np.ndarray, Optional[np.ndarray], str, List[str]]:
    """-> (X [N, D], labels|None, label_col, numeric_cols)."""
    if path.suffix == ".npz":
        data = np.load(path, allow_pickle=False)
        if "Z" not in data:
            raise SystemExit(f"❌ npz has no 'Z' array: {path}")
        X = data["Z"]
        return X, None, "", [f"z{i}" for i in range(X.shape[1])]

    try:
        import pandas as pd
    except ImportError:
        raise SystemExit(f"❌ reading {path.name} needs pandas, which does not import here; "
                         "pass an .npz latent cache (--parquet cache_npz/<file>.npz)") from None

    df = pd.read_parquet(path)
    label_col = next((c for c in LABEL_CANDIDATES if c in df.columns), None)
    numeric = df.select_dtypes(include=[np.number]).columns.tolist()
    if not numeric:
        raise SystemExit("❌ no numeric columns in the parquet (no latents).")
    X = df[numeric].to_numpy()
    labels = df[label_col].to_numpy() if label_col else None
    return X, labels, label_col or "", numeric


def find_default_table(project_root: Path) -> Optional[Path]:
    for pattern in ("downloaded_models/**/*.parquet", "**/features.parquet", "cache_npz/*.npz", "*.parquet"):
        hits = sorted(project_root.glob(pattern))
        if hits:
            return hits[0]
    return None


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--parquet", type=str, default=None, help="path to .parquet or .npz latents")
    p.add_argument("--n", type=int, default=2)
    p.add_argument("--all", action="store_true")
    p.add_argument("--jsonl", action="store_true")
    p.add_argument("--precision", type=int, default=6)
    p.add_argument("--max-width", type=int, default=160)
    p.add_argument("--show-cols", action="store_true")
    args = p.parse_args(argv)

    from anuraxla_torch.utils.io import find_project_root

    root = find_project_root(Path.cwd())
    path = Path(args.parquet) if args.parquet else find_default_table(root)
    if path is None or not Path(path).exists():
        raise SystemExit(
            f"❌ no latent table found (searched under {root}); pass --parquet explicitly."
        )

    X, labels, label_col, cols = load_table(Path(path))
    n_total, dim = X.shape
    print("=" * 70)
    print("🧠 LATENT SPACE (no dimensionality reduction)")
    print("=" * 70)
    print(f"📌 points: {n_total}")
    print(f"📐 latent dim: {dim}")
    if label_col:
        print(f"🏷️ label column: '{label_col}'")
    if args.show_cols:
        for c in cols:
            print(f"  - {c}")
    print("-" * 70)

    n = n_total if args.all else min(args.n, n_total)
    np.set_printoptions(precision=args.precision, suppress=True, linewidth=args.max_width)
    for i in range(n):
        if args.jsonl:
            print(json.dumps({
                "index": i,
                "label_col": label_col or None,
                "label": None if labels is None else str(labels[i]),
                "vector": [float(v) for v in X[i]],
            }, ensure_ascii=False))
        else:
            header = f"[{i}]" + (f" {label_col}={labels[i]}" if labels is not None else "")
            print(header)
            print(X[i])
            print()
    if n_total > n:
        print(f"… (shown {n}/{n_total}; use --all for everything)")


if __name__ == "__main__":
    main()
