"""The traced run's profiler and what is read from it.

``torch.profiler`` records the card's kernels, copies and sets (CUPTI), the
host's CUDA runtime calls and the harness's ``record_function`` ranges. The
reduction keeps, in nanoseconds on one clock:

- ``device``: every device activity (kernel, memcpy, memset) as
  (start, end, name, kind), clipped to the window;
- ``launch``: the host time and thread of each runtime call, by correlation
  id, so that a kernel can be tied to the host range that launched it;
- ``ranges``: the harness's ranges (``perfbench::...``) and the host's
  operator events, as (name, start, end, thread).

Readers under ``perfbench/metrics/`` take their numbers from these lists.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "perfbench::window"
CALL = "perfbench::call"


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        if "htod" in low:
            return "memcpy_htod"
        if "dtoh" in low:
            return "memcpy_dtoh"
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


@dataclass
class Trace:
    window: Tuple[int, int]
    device: List[Tuple[int, int, str, str, int]] = field(default_factory=list)  # start, end, name, kind, corr
    launch: Dict[int, Tuple[int, int]] = field(default_factory=dict)  # corr -> (host start, thread)
    ranges: List[Tuple[str, int, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def kernels(self, kind: str = "kernel"):
        return [d for d in self.device if d[3] == kind]

    def busy_ns(self) -> int:
        """Length of the union of the device activity's intervals."""
        ev = sorted((s, e) for s, e, *_ in self.device)
        total, cur_s, cur_e = 0, None, None
        for s, e in ev:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def named_ranges(self, name: str):
        return [(s, e, t) for n, s, e, t in self.ranges if n == name]

    def launched_within(self, name: str, kind: Optional[str] = "kernel"):
        """Device events whose runtime call lay inside a host range ``name`` on its thread."""
        spans = sorted(self.named_ranges(name))
        if not spans:
            return []
        starts = [s for s, _, _ in spans]
        out = []
        for d in self.device:
            if kind is not None and d[3] != kind:
                continue
            host = self.launch.get(d[4])
            if host is None:
                continue
            t, tid = host
            i = bisect.bisect_right(starts, t) - 1  # ranges of one name do not nest on a thread
            if i >= 0 and t <= spans[i][1] and spans[i][2] == tid:
                out.append(d)
        return out

    def gaps(self, n: int = 10):
        """The ``n`` longest idle stretches of the device inside the window,
        each named by the harness's layer range (on any thread) that fills
        most of it, else by the innermost host operator on the window's
        thread at its middle."""
        ev = sorted((s, e) for s, e, *_ in self.device)
        w0, w1 = self.window
        idle, cur = [], w0
        for s, e in ev:
            if s > cur:
                idle.append((cur, s))
            cur = max(cur, e)
        if w1 > cur:
            idle.append((cur, w1))
        idle.sort(key=lambda g: g[0] - g[1])
        main = {t for n_, s, e, t in self.ranges if n_ == WINDOW}
        layers = [(s, e, name) for name, s, e, _ in self.ranges if name.startswith("perfbench::")
                  and name not in (WINDOW, CALL)]
        out = []
        for a, b in idle[:n]:
            busy: Dict[str, int] = {}
            for s, e, name in layers:
                if s < b and e > a:
                    busy[name] = busy.get(name, 0) + min(e, b) - max(s, a)
            mid = (a + b) // 2
            ops = [(e - s, name) for name, s, e, t in self.ranges
                   if s <= mid <= e and t in main and not name.startswith("perfbench::")]
            label = max(busy, key=busy.get) if busy else (min(ops)[1] if ops else CALL)
            out.append([label, (b - a) * 1e-9])
        return out

    def top_ops(self, n: int = 10):
        tot: Dict[str, int] = {}
        for s, e, name, kind, _ in self.device:
            tot[name] = tot.get(name, 0) + (e - s)
        return [[k, v * 1e-9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


class Tracer:
    """Profiles the block it wraps when ``enabled``; ``trace`` holds the
    reduction afterwards. The block is the window: it opens the ``WINDOW``
    range itself."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Optional[Trace] = None
        self._prof = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = self._stack.enter_context(profile(activities=acts))
        self._stack.enter_context(torch.profiler.record_function(WINDOW))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        if self._prof is not None and exc[0] is None:
            self.trace = reduce(self._prof)
        return False


def reduce(prof) -> Trace:
    events = prof.profiler.kineto_results.events()
    ranges, launch, device = [], {}, []
    window = None
    for ev in events:
        name = ev.name()
        s, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            tid = ev.start_thread_id()
            if name == WINDOW:
                window = (s, s + dur)
            low = name.lower()
            if low.startswith(("cuda", "cu")) and ("launch" in low or "memcpy" in low or "memset" in low):
                launch[ev.correlation_id()] = (s, tid)
            ranges.append((name, s, s + dur, tid))
    names = {r[0] for r in ranges}
    for ev in events:
        if ev.device_type() != torch.autograd.DeviceType.CPU:
            name = ev.name()
            if name in names or ev.is_user_annotation():
                continue
            corr = ev.correlation_id()
            if corr not in launch:
                corr = ev.linked_correlation_id()
            device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), name, _kind(name), corr))
    if window is None:
        raise RuntimeError("the profiler's trace holds no window range")
    w0, w1 = window
    device = [(max(s, w0), min(e, w1), n, k, c) for s, e, n, k, c in device if e > w0 and s < w1]
    return Trace(window=window, device=device, launch=launch, ranges=ranges)


class FunctionRange:
    """Replaces ``owner.attr`` (a function of a module, or a method of a class)
    by a wrapper that opens a ``record_function`` range around each call,
    while installed; the wrapper keeps the original's attributes."""

    def __init__(self, owner, attr: str, name: str):
        self.owner, self.attr, self.name = owner, attr, name
        self.orig = None

    def __enter__(self):
        self.orig = getattr(self.owner, self.attr)
        orig, name = self.orig, self.name

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                return orig(*args, **kwargs)

        setattr(self.owner, self.attr, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.orig)
        return False


def layer_ranges(module: torch.nn.Module, ranges) -> contextlib.ExitStack:
    """The encoder's range and each (dotted owner, attribute, range name) of
    ``ranges``, installed together."""
    stack = contextlib.ExitStack()
    if module is not None:
        stack.enter_context(ModuleRange(module, "perfbench::encoder"))
    for owner, attr, name in ranges:
        mod, _, cls = owner.partition(":")
        obj = importlib.import_module(mod)
        stack.enter_context(FunctionRange(getattr(obj, cls) if cls else obj, attr, name))
    return stack


class ModuleRange:
    """Opens a ``record_function`` range around every forward of a module (a
    pre-hook enters it, a hook leaves it), while installed."""

    def __init__(self, module: torch.nn.Module, name: str):
        self.module, self.name, self._open, self._handles = module, name, [], []

    def __enter__(self):
        def pre(_m, _args):
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
            self._open.append(rf)

        def post(_m, _args, _out):
            self._open.pop().__exit__(None, None, None)

        self._handles = [self.module.register_forward_pre_hook(pre), self.module.register_forward_hook(post)]
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        return False
