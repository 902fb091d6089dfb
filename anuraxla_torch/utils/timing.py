"""Stage timing and tracing — the port of ``anuraxla/utils/timing.py``
(``StageTimer``, ``stage_timer``, ``maybe_trace``), and the port's spans.

Every pipeline stage gets wall-clock and throughput numbers, forwarded to the
metrics sink (``utils.metrics``), and an opt-in trace: with
``ANURAXLA_TRACE_DIR`` set, ``maybe_trace`` wraps the region in
``torch.profiler`` (the reference uses ``jax.profiler``) and writes a Chrome
trace, viewable in Perfetto or TensorBoard, to
``<ANURAXLA_TRACE_DIR>/<name>/trace.json``, and the program's spans of the
region beside it as ``spans.jsonl``.

**Spans.** ``span(name, id=None, **counts)`` marks one piece of host work at a
layer boundary (decode, the wait on the prefetch thread, a ring slot's wait,
a fetch of a result, ...). With no profiler running it costs one check of
``torch.autograd.profiler._is_profiler_enabled`` — a flag the profiler sets
for every thread — and returns a shared no-op. While a profiler runs it
appends a :class:`SpanRecord` to a bounded in-memory buffer: its start and
end on ``time.time_ns()`` (the profiler's own clock), its thread, its parent
(the enclosing open span on that thread), its ``id`` (a request's number or a
batch's first row, else its parent's) and its counts. Where the profiler
records the current thread (its main thread; a ``ThreadPoolExecutor`` thread
is not recorded), the span also opens ``record_function("anuraxla::" +
name)``, so the kernels launched inside it can be tied to it by correlation
id. ``spans(t0_ns, t1_ns)`` reads the records that lie inside an interval.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

SPAN_PREFIX = "anuraxla::"  # the profiler range of a span on a recorded thread
SPAN_CAPACITY = 1 << 17  # records the buffer holds; it refuses (and counts) the rest

_clock = time.time_ns  # the profiler's clock: kineto stamps its events in Unix nanoseconds


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int  # threading.get_native_id() of the thread that ran it
    seq: int  # this span's number, in the order spans opened
    parent: Optional[int]  # seq of the enclosing open span on the same thread
    id: Optional[int]  # the request's number or the batch's first row, else the parent's
    counts: Dict[str, float]


_records: List[SpanRecord] = []
_lock = threading.Lock()
_dropped = 0
_first_drop_end_ns: Optional[int] = None  # end of the first record refused: the buffer was full from then on
_seq = itertools.count(1)
_local = threading.local()


def _keep(rec: SpanRecord) -> None:
    global _dropped, _first_drop_end_ns
    with _lock:
        if len(_records) < SPAN_CAPACITY:
            _records.append(rec)
            return
        _dropped += 1
        if _first_drop_end_ns is None:
            _first_drop_end_ns = rec.end_ns


class _NoSpan:
    """The span handed out while no profiler runs: it records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):  # named, not *exc: no tuple made a call
        return None

    def __setitem__(self, key, value):
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "id", "counts", "seq", "parent", "start_ns", "_range", "_stack")

    def __init__(self, name: str, id: Optional[int], counts: Dict[str, float]):
        self.name, self.id, self.counts = name, id, counts

    def __setitem__(self, key: str, value) -> None:
        """Set a count while the span is open."""
        self.counts[key] = value

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.parent = up.seq if up is not None else None
        if self.id is None and up is not None:
            self.id = up.id
        self.seq = next(_seq)
        stack.append(self)
        self._stack = stack
        self._range = None
        if torch.autograd._profiler_enabled():  # the profiler records this thread
            self._range = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self._range.__enter__()
        # each stamp follows the range's own: the range's cost before its stamp stays out of the span
        self.start_ns = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        end = _clock()
        self._stack.pop()
        _keep(SpanRecord(self.name, self.start_ns, end, threading.get_native_id(), self.seq, self.parent,
                         self.id, self.counts))
        return None


def span(name: str, id: Optional[int] = None, **counts):
    """A context manager around one piece of host work; ``counts`` (and
    ``s[key] = value`` while it is open) are numbers of that work. Records
    only while a profiler runs."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, id, counts)


def _kept(t0_ns: Optional[int], t1_ns: Optional[int]) -> List[SpanRecord]:
    with _lock:
        recs = list(_records)
    return [r for r in recs if (t0_ns is None or r.start_ns >= t0_ns) and (t1_ns is None or r.end_ns <= t1_ns)]


def spans(t0_ns: Optional[int] = None, t1_ns: Optional[int] = None) -> Optional[List[SpanRecord]]:
    """The records that lie wholly inside [t0_ns, t1_ns] (Unix nanoseconds;
    None: unbounded), in the order they closed; None where the buffer refused
    a record that may have lain there."""
    with _lock:
        if _first_drop_end_ns is not None and (t1_ns is None or _first_drop_end_ns <= t1_ns):
            return None
    return _kept(t0_ns, t1_ns)


def dropped() -> int:
    """Records the full buffer refused since it was last cleared."""
    return _dropped


def clear_spans() -> None:
    global _dropped, _first_drop_end_ns
    with _lock:
        _records.clear()
        _dropped, _first_drop_end_ns = 0, None


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
    """Times the block; it is also a span of ``name`` (``items``: ``n_items``)."""
    t = StageTimer(name, n_items)
    start = time.perf_counter()
    try:
        with span(name, items=n_items):
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
    host activity, and the card's kernels where the process has a card,
    in ``trace.json``; the program's spans of the region in ``spans.jsonl``,
    one JSON object a span (``counts`` nested), then ``{"dropped": n}`` where
    the buffer refused records; then the buffer is cleared. Where a profiler
    already runs, the region is left to it: no second profiler opens and
    nothing is written."""
    trace_dir = os.environ.get("ANURAXLA_TRACE_DIR")
    if not trace_dir or _profiler._is_profiler_enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        t0 = _clock()
        yield
        t1 = _clock()
    out = os.path.join(trace_dir, name)
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    with open(os.path.join(out, "spans.jsonl"), "w", encoding="utf-8") as f:
        for r in _kept(t0, t1):
            f.write(json.dumps(r._asdict(), default=float) + "\n")
        if _dropped:
            f.write(json.dumps({"dropped": _dropped}) + "\n")
    clear_spans()
