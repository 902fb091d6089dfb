"""What the program's spans cost while a profiler runs, on a served path: one
process sets a benchmark cell up, then, under one ``torch.profiler`` session
(CPU and CUDA activities, as a traced run), times its calls (requests or
passes) in blocks with the spans on, with every module's ``span`` replaced
by the shared no-op (off), and with spans that keep their records but open
no profiler range (records), in the order on, off, records, records, off,
on, repeated. ``--ranges`` also installs the harness's own ranges, as a
traced run of the benchmark does.

    python <this file> --workload stride-request-parity --seed 7 --calls 300 [--ranges]

from the root of a checkout, on a machine with a card. Prints one JSON line:
each side's call times in ms (median, quartiles, p95) and their count."""

from __future__ import annotations

import argparse
import importlib
import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

USERS = ("anuraxla_torch.utils.timing", "anuraxla_torch.pipeline.dataset", "anuraxla_torch.pipeline.session",
         "anuraxla_torch.pipeline.stream", "anuraxla_torch.pipeline.benchmark", "anuraxla_torch.cli.evaluate_wav")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, required=True, help="calls a block")
    p.add_argument("--ranges", action="store_true", help="install the harness's ranges too")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import harness
    from anuraxla_torch.utils import timing

    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(args.workload, manifest)
    work = Path(tempfile.mkdtemp(prefix="span-on-cost-"))
    mods = [importlib.import_module(m) for m in USERS]
    real = timing.span

    def off(*_a, **_k):
        return timing._NO_SPAN

    class NoRange(timing._Span):
        """A span as the program's, less its profiler range."""

        __slots__ = ()

        def __enter__(self):
            stack = getattr(timing._local, "stack", None)
            if stack is None:
                stack = timing._local.stack = []
            up = stack[-1] if stack else None
            self.parent = up.seq if up is not None else None
            if self.id is None and up is not None:
                self.id = up.id
            self.seq = next(timing._seq)
            stack.append(self)
            self._stack, self._range = stack, None
            self.start_ns = timing._clock()
            return self

    def records(name, id=None, **counts):
        return NoRange(name, id, counts)

    sides = {"on": real, "off": off, "records": records}
    times = {k: [] for k in sides}
    try:
        drv = harness.driver_class(cell.kind)(cell, args.seed, torch.device("cuda"), work)
        drv.setup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]), drv.layer_ranges(args.ranges):
            for side in ("on", "off", "records", "records", "off", "on") * 2:
                for m in mods:
                    m.span = sides[side]
                for _ in range(args.calls):
                    t = time.perf_counter()
                    drv.unit()
                    times[side].append((time.perf_counter() - t) * 1e3)
        for m in mods:
            m.span = real
        n_spans = len(timing.spans() or [])
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def summary(v):
        q = statistics.quantiles(v, n=4)
        return {"n": len(v), "median": statistics.median(v), "q1": q[0], "q3": q[2],
                "p95": float(np.percentile(v, 95))}

    print(json.dumps({"workload": args.workload, "seed": args.seed, "harness_ranges": args.ranges,
                      "spans_recorded": n_spans, **{k: summary(v) for k, v in times.items()},
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
