"""One traced run of a benchmark cell (``perfbench/run.py --trace 1``), then
the card's longest idle gaps put down to the program's spans open on each
thread during them, and the spans' totals inside the window.

    python <this file> --workload avgpool-scan-balanced --seed 7 [--seconds 10]

from the root of a checkout, on a machine with a card. Prints the cell's
result line, then one JSON line: ``gaps`` (the ten longest idle stretches,
each with the harness's label and, by thread, the program spans overlapping
it in ms; "main" is the thread of the served loop), ``totals`` (count, ms,
summed counts and threads by span name in the window),
``harness_ranges`` (the harness's ``perfbench::`` ranges in the trace, by
name: count and threads) and ``anuraxla_ranges`` (the program's own ranges
in the trace, by name)."""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))


def idle_gaps(trace, n):
    ev = sorted((s, e) for s, e, *_ in trace.device)
    w0, w1 = trace.window
    idle, cur = [], w0
    for s, e in ev:
        if s > cur:
            idle.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        idle.append((cur, w1))
    return sorted(idle, key=lambda g: g[0] - g[1])[:n]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)

    from perfbench import harness

    seen = {}
    orig = harness.reader

    def spy(metric):
        f = orig(metric)

        def read(r):
            seen["r"] = r
            return f(r)

        return read

    harness.reader = spy
    harness.run_cell(args.workload, args.seed, args.seconds, True, device="cuda")
    r = seen["r"]
    t = r.trace
    try:
        from anuraxla_torch.utils.timing import dropped, spans
        recs, n_dropped = spans(*t.window) or [], dropped()
    except ImportError:  # a program without spans
        recs, n_dropped = [], None
    main_tid = next((x.thread for x in recs if x.name in ("dispatch", "request", "tree_scan")), None)
    label = dict(zip([tuple(g) for g in idle_gaps(t, 10)], [g[0] for g in t.gaps(10)]))
    out_gaps = []
    for a, b in idle_gaps(t, 10):
        by_thread = defaultdict(dict)
        for x in recs:
            ov = min(x.end_ns, b) - max(x.start_ns, a)
            if ov > 0:
                who = "main" if x.thread == main_tid else f"thread-{x.thread}"
                by_thread[who][x.name] = round(by_thread[who].get(x.name, 0.0) + ov * 1e-6, 3)
        out_gaps.append({"ms": round((b - a) * 1e-6, 3), "at_s": round((a - t.window[0]) * 1e-9, 3),
                         "harness_label": label.get((a, b)), "spans": by_thread})
    totals = defaultdict(lambda: {"n": 0, "ms": 0.0, "counts": defaultdict(float), "threads": set()})
    for x in recs:
        tot = totals[x.name]
        tot["n"] += 1
        tot["ms"] += (x.end_ns - x.start_ns) * 1e-6
        tot["threads"].add("main" if x.thread == main_tid else "other")
        for k, v in x.counts.items():
            tot["counts"][k] += float(v)
    ranges = defaultdict(lambda: {"n": 0, "threads": set()})
    for name, s, e, tid in t.ranges:
        if name.startswith(("perfbench::", "anuraxla::")):
            ranges[name]["n"] += 1
            ranges[name]["threads"].add(tid)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "window_s": t.window_s, "dropped": n_dropped,
        "passes_or_requests": r.window.calls, "counts": r.counts, "gaps": out_gaps,
        "totals": {k: {"n": v["n"], "ms": round(v["ms"], 3), "counts": dict(v["counts"]), "threads": sorted(v["threads"])}
                   for k, v in totals.items()},
        "harness_ranges": {k: {"n": v["n"], "threads": len(v["threads"])} for k, v in ranges.items()
                           if k.startswith("perfbench::")},
        "anuraxla_ranges": {k: {"n": v["n"], "threads": len(v["threads"])} for k, v in ranges.items()
                            if k.startswith("anuraxla::")},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
