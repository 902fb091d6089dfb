"""Structured metrics forwarding — a copy of ``anuraxla/utils/metrics.py``
(``log_metrics``, ``get_metrics``, ``reset_metrics_sink`` and the sinks).

Every stage timer emits structured records through one process-wide
sink, selected by environment (the same variables as the reference):

- ``ANURAXLA_METRICS_FILE=<path>``: append one JSON object per record (JSONL);
- ``ANURAXLA_WANDB=1``: forward to ``wandb.log`` when the package is
  installed (a lazy, optional import: its absence falls back to the
  JSONL/no-op sinks);
- neither: a zero-overhead no-op.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Mapping, Optional


class NullSink:
    enabled = False

    def log(self, record: Mapping, step: Optional[int] = None) -> None:  # noqa: ARG002
        pass

    def close(self) -> None:
        pass


class JsonlSink:
    """Append-only JSONL metrics file; thread-safe (stage timers fire from
    prefetch threads)."""

    enabled = True

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def log(self, record: Mapping, step: Optional[int] = None) -> None:
        rec = {"ts": time.time(), **record}
        if step is not None:
            rec["step"] = int(step)
        line = json.dumps(rec)
        with self._lock, open(self.path, "a", encoding="utf-8") as f:
            f.write(line + "\n")

    def close(self) -> None:
        pass


class WandbSink:
    enabled = True

    def __init__(self):
        import wandb  # gated: only reached with ANURAXLA_WANDB=1

        if wandb.run is None:
            wandb.init(project=os.environ.get("ANURAXLA_WANDB_PROJECT", "anuraxla"))
        self._wandb = wandb

    def log(self, record: Mapping, step: Optional[int] = None) -> None:
        self._wandb.log(dict(record), step=step)

    def close(self) -> None:
        self._wandb.finish()


class FanoutSink:
    enabled = True

    def __init__(self, sinks):
        self.sinks = sinks

    def log(self, record, step=None):
        for s in self.sinks:
            s.log(record, step)

    def close(self):
        for s in self.sinks:
            s.close()


_sink = None
_sink_lock = threading.Lock()


def get_metrics():
    """The process-wide sink, resolved from the environment on first use."""
    global _sink
    if _sink is None:
        with _sink_lock:
            if _sink is None:
                sinks = []
                path = os.environ.get("ANURAXLA_METRICS_FILE")
                if path:
                    sinks.append(JsonlSink(path))
                if os.environ.get("ANURAXLA_WANDB") == "1":
                    try:
                        sinks.append(WandbSink())
                    except Exception:  # wandb absent/offline: degrade silently
                        pass
                _sink = sinks[0] if len(sinks) == 1 else (
                    FanoutSink(sinks) if sinks else NullSink()
                )
    return _sink


def log_metrics(record: Mapping, step: Optional[int] = None) -> None:
    s = get_metrics()
    if s.enabled:
        s.log(record, step)


def reset_metrics_sink() -> None:
    """Re-resolve from the environment (tests change env per case)."""
    global _sink
    with _sink_lock:
        _sink = None
