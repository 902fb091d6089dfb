"""One run of one cell: set-up, the measured window, the traced readings, the
check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, cell or metric is
found by name (``BENCHMARK.json`` names them):

- ``perfbench/configs/<config>.json``: the model configuration as run;
- ``perfbench/traffic/<traffic>.json``: a traffic mix, whose ``kind`` names
  the driver ``perfbench/drivers/<kind>.py`` that generates it and runs its
  passes;
- ``perfbench/workloads/<cell>.json``: the cell's session knobs, its control
  precisions and the limits of its comparison;
- ``perfbench/metrics/<metric>.py``: a reader with ``read(reading)`` that
  returns the metric's value, or None where it finds nothing to read. A
  metric split by the end-to-end metric it moves (``device_idle_pct.train``)
  falls back to the reader of the name before its first dot.

``perfbench/held_back.json`` keeps, in BENCHMARK.json's form, cells whose
runs spread too widely for a bound, with the metrics only they report: the
benchmark does not run them, the CPU tests do.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import devtrace

PB = Path(__file__).resolve().parent
ROOT = PB.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "anuraxla")  # compared whole, by top-level name
TRACE_SECONDS = 10.0  # a traced run profiles this much of its window at most, so its trace stays readable in time


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry of BENCHMARK.json
    cfg: dict
    mix: dict
    workload: dict

    @property
    def kind(self) -> str:
        return self.mix["kind"]


def load_cell(name: str, manifest: dict, pb: Path = PB) -> Cell:
    """The cell ``name`` of ``manifest``, its files read from under ``pb``."""
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    cfg = load_json(pb / "configs" / f"{entry['config']}.json")
    cfg["input_hw"] = [cfg["mel"]["target_frames"], cfg["mel"]["n_mels"]]
    return Cell(name, entry, cfg, load_json(pb / "traffic" / f"{entry['traffic']}.json"),
                load_json(pb / "workloads" / f"{name}.json"))


def driver_class(kind: str):
    return importlib.import_module(f"perfbench.drivers.{kind}").Driver


def reader_path(metric: str) -> Path:
    """``metrics/<metric>.py``, else ``metrics/<the name before its first dot>.py``."""
    path = PB / "metrics" / f"{metric}.py"
    return path if path.is_file() else PB / "metrics" / f"{metric.split('.')[0]}.py"


def reader(metric: str):
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def wanted_metrics(cell: str, manifest: dict, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``--trace 0``) or per-layer ones (``--trace 1``)."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"] if cell in m.get("workloads", [cell] if m["moves"] in mine else [])]


@dataclasses.dataclass
class Window:
    units: int  # chunks, requests or examples completed
    seconds: float
    calls: int  # passes, requests or steps
    latencies: List[float]  # seconds of each call


@dataclasses.dataclass
class Reading:
    """What a metric reader reads."""

    cell: Cell
    window: Window
    setup_s: float
    trace: Optional[devtrace.Trace]
    spans: Dict[str, tuple]  # host spans the driver timed: name -> (count, seconds)
    counts: Dict[str, float]  # batches, mel rows, ... in the window


def process_start() -> float:
    """The wall time this process started (``/proc``), else now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        btime = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + start / ticks
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def measure(drv, seconds: float) -> Window:
    """Whole calls of the driver's unit until ``seconds`` have passed."""
    lat, units = [], 0
    t0 = t1 = time.perf_counter()
    while t1 - t0 < seconds:
        t = time.perf_counter()
        with torch.profiler.record_function("perfbench::call"):
            units += drv.unit()
        t1 = time.perf_counter()
        lat.append(t1 - t)
    return Window(units=units, seconds=t1 - t0, calls=len(lat), latencies=lat)


def host_counters() -> Dict[str, float]:
    """This process's CPU seconds, faults and context switches, and the host's
    stolen share of its CPU time (``/proc/stat``), as they stand."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"user_s": ru.ru_utime, "sys_s": ru.ru_stime, "minflt": ru.ru_minflt, "nivcsw": ru.ru_nivcsw}
    try:
        cpu = [int(v) for v in Path("/proc/stat").read_text().splitlines()[0].split()[1:]]
        out["steal_jiffies"], out["all_jiffies"] = cpu[7] if len(cpu) > 7 else 0, sum(cpu)
    except (OSError, ValueError, IndexError):
        pass
    return out


def device_info(dev: torch.device, chips: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              f"--id={dev.index or 0}"], capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             manifest: Optional[dict] = None, cell: Optional[Cell] = None, t_start: Optional[float] = None,
             out=sys.stdout, err=sys.stderr) -> dict:
    """Run one cell once; prints the compared numbers on ``err`` and the result
    line on ``out``, and returns the result. ``cell`` (tests) replaces the one
    the manifest names."""
    t_start = process_start() if t_start is None else t_start
    manifest = manifest if manifest is not None else load_json(ROOT / "BENCHMARK.json")
    cell = cell or load_cell(name, manifest)
    dev = torch.device(device)
    work = Path(tempfile.mkdtemp(prefix=f"perfbench-{cell.name}-"))
    try:
        drv = driver_class(cell.kind)(cell, seed, dev, work)
        drv.setup()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s = time.time() - t_start
        tracer = devtrace.Tracer(trace)
        host0 = host_counters()
        with tracer, drv.layer_ranges(trace):
            win = measure(drv, min(seconds, TRACE_SECONDS) if trace else seconds)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        host = {k: v - host0.get(k, 0) for k, v in host_counters().items()}
        spans = drv.after_window() if trace else {}
        info = device_info(dev, int(cell.entry.get("chips", 1)))
        counts = drv.counts(win)
        drv.release()
        compared = drv.check()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    reading = Reading(cell, win, setup_s, tracer.trace, spans, counts)
    metrics = {}
    for m in wanted_metrics(cell.name, manifest, trace):
        v = reader(m["name"])(reading)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if trace:
        tr = tracer.trace
        info["busy_s"] = tr.busy_ns() * 1e-9 if tr is not None else 0.0
        info["window_s"] = tr.window_s if tr is not None else win.seconds
    correct = all(v <= lim for v, lim in compared.values())
    result = {"correct": correct, "attempted": counts["attempted"], "failed": counts["failed"],
              "metrics": metrics, "device": info}
    if trace and tracer.trace is not None:
        result["breakdown"] = {"device_ops": tracer.trace.top_ops(10), "idle_gaps": tracer.trace.gaps(10)}
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    lat = np.asarray(win.latencies) * 1e3
    if lat.size:
        drv.diag["call_ms"] = [float(v) for v in np.percentile(lat, [0, 25, 50, 75, 100])]
        drv.diag["calls"] = int(lat.size)
        drv.diag["first_calls_ms"] = [float(v) for v in lat[:4]]
    # what the host did over the window: the spread of a host-bound cell follows it
    drv.diag["host"] = {k: float(v) for k, v in host.items()}
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark must not load: {found}", file=err)
        raise SystemExit(3)
    print("diag " + json.dumps(drv.diag), file=err)
    for k, (v, lim) in compared.items():
        print(f"{k} {v!r} limit {lim!r}", file=err)
    print(json.dumps(result), file=out, flush=True)
    return result

