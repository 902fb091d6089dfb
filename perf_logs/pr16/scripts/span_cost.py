"""What a span costs: ``span()`` with no profiler running (10^6 calls, less an
empty loop of the same length), and with one running, on the main thread
(which the profiler records: a ``record_function`` range too) and on a
``ThreadPoolExecutor`` thread (which it does not: the record alone).

    python <this file>

from the root of a checkout. Prints one JSON line of nanoseconds a span."""

from __future__ import annotations

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from anuraxla_torch.utils import timing  # noqa: E402


def per_call_ns(n: int) -> float:
    t = time.perf_counter_ns()
    for _ in range(n):
        pass
    empty = time.perf_counter_ns() - t
    t = time.perf_counter_ns()
    for _ in range(n):
        with timing.span("fetch", rows=1):
            pass
    return (time.perf_counter_ns() - t - empty) / n


def main() -> int:
    off = [per_call_ns(10 ** 6) for _ in range(3)]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        on_main = per_call_ns(10 ** 4)
        with ThreadPoolExecutor(max_workers=1) as ex:
            on_worker = ex.submit(per_call_ns, 10 ** 4).result()
    timing.clear_spans()
    print(json.dumps({"off_ns": off, "on_main_ns": on_main, "on_worker_ns": on_worker,
                      "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
