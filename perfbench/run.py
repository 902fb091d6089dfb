"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload stride-folder-balanced --seed 7 --seconds 10 --trace 0

from the root of a checkout that holds the PyTorch/CUDA port
(``anuraxla_torch``). ``--trace 0`` measures the cell's end-to-end metrics,
``--trace 1`` its per-layer ones under the profiler. The last line on
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, in a traced run ``breakdown``, and last the numbers
compared with the reference, each beside its limit); the same numbers are the
last lines on standard error. Exits non-zero, printing no result, without
enough CUDA devices, or when a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

T_START = time.time()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from perfbench import harness

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(args.workload, manifest)
    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda",
                     manifest=manifest, cell=cell, t_start=min(T_START, harness.process_start()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
