"""The control of a cell's comparison: the plain reference computed one step
below the precisions the cell states (the workload's ``control``: TF32 below
float32, fp8 below bfloat16), put in the program's place on the cell's own
inputs at the cell's own size, and compared with the reference as the
program is. It has to come out as not correct. (A training cell runs the
program as far as the call its check follows, and steps the control from the
program's state there.)

    python3 perfbench/control.py --workload stride-folder-balanced --seeds 11 12 13

prints one JSON line a seed with the comparison's numbers and the cell's limits.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def control_readings(cell, seeds, device, out=sys.stdout):
    from perfbench import harness

    rows = []
    for seed in seeds:
        work = Path(tempfile.mkdtemp(prefix=f"perfbench-control-{cell.name}-"))
        try:
            drv = harness.driver_class(cell.kind)(cell, seed, device, work)
            drv.setup(program=getattr(drv, "CONTROL_RUNS_PROGRAM", False))
            got = drv.control_numbers()
        finally:
            shutil.rmtree(work, ignore_errors=True)
        lim = cell.workload["limits"]
        row = {"workload": cell.name, "seed": seed, "numbers": got, "limits": lim,
               "correct": all(got[k] <= lim[k] for k in lim)}
        print(json.dumps(row), file=out, flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from perfbench import harness

    cell = harness.load_cell(args.workload, harness.load_json(ROOT / "BENCHMARK.json"))
    control_readings(cell, args.seeds, torch.device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
