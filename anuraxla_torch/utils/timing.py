"""Stage timing and optional tracing — the port of ``anuraxla/utils/timing.py``
(``StageTimer``, ``stage_timer``, ``maybe_trace``).

Every pipeline stage gets wall-clock and throughput numbers, forwarded to the
metrics sink (``utils.metrics``), and an opt-in trace: with
``ANURAXLA_TRACE_DIR`` set, ``maybe_trace`` wraps the region in
``torch.profiler`` (the reference uses ``jax.profiler``) and writes a Chrome
trace, viewable in Perfetto or TensorBoard, to
``<ANURAXLA_TRACE_DIR>/<name>/trace.json``.
"""

from __future__ import annotations

import contextlib
import os
import time


class StageTimer:
    def __init__(self, name: str, n_items: int = 0):
        self.name = name
        self.n_items = n_items
        self.seconds = 0.0

    @property
    def rate(self) -> float:
        return self.n_items / self.seconds if self.seconds > 0 else float("nan")


@contextlib.contextmanager
def stage_timer(name: str, n_items: int = 0, log=print):
    t = StageTimer(name, n_items)
    start = time.perf_counter()
    try:
        yield t
    finally:
        t.seconds = time.perf_counter() - start
        if log is not None:
            extra = f" ({t.rate:.1f} items/s)" if n_items else ""
            log(f"⏱️ {name}: {t.seconds:.3f}s{extra}")
        # structured forwarding (no-op unless a metrics sink is configured)
        from anuraxla_torch.utils.metrics import log_metrics

        log_metrics(
            {"kind": "stage", "stage": name, "seconds": t.seconds,
             **({"n_items": t.n_items, "rate": t.rate} if n_items else {})}
        )


@contextlib.contextmanager
def maybe_trace(name: str = "anuraxla"):
    """Wrap a region in a torch.profiler trace when ANURAXLA_TRACE_DIR is set:
    host activity, and the card's kernels where the process has a card."""
    trace_dir = os.environ.get("ANURAXLA_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield
    out = os.path.join(trace_dir, name)
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
