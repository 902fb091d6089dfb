"""Decision equivalence of two folder benchmarks — the inline diff of the
reference's ``scripts/drive_fast_tier.sh:28-44``: the per-file
(pred_species, detected) of two ``results.csv`` files, the share that is
identical, and each file that differs.

    python -m anuraxla_torch.scripts.decision_diff outputs/tier_balanced/results.csv outputs/tier_fast/results.csv
"""

from __future__ import annotations

import argparse
import csv


def decisions(path) -> dict:
    with open(path) as f:
        return {r["file"]: (r["pred_species"], r["detected"]) for r in csv.DictReader(f)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("balanced", help="results.csv of the balanced tier's benchmark")
    p.add_argument("fast", help="results.csv of the fast tier's benchmark")
    args = p.parse_args(argv)

    bal = decisions(args.balanced)
    fast = decisions(args.fast)
    if bal.keys() != fast.keys():
        raise SystemExit(f"❌ the two benchmarks cover different files ({len(bal)} and {len(fast)})")
    diff = {k for k in bal if bal[k] != fast[k]}
    n = len(bal)
    print(f"decision equivalence: {n - len(diff)}/{n} identical "
          f"({100 * (n - len(diff)) / n:.2f}%)")
    for k in sorted(diff):
        print(f"  DIFFERS {k}: balanced={bal[k]} fast={fast[k]}")


if __name__ == "__main__":
    main()
