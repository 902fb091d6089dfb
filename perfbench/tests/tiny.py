"""Cells of BENCHMARK.json, and of ``held_back.json`` beside it, cut to a size
the CPU runs in seconds, for the tests: the same driver, session knobs and
limits; fewer files, shorter recordings, smaller batches; the configuration
as its family cuts it for the CPU (``cpu_cut``: published widths stay for
the card)."""

from __future__ import annotations

import io
import json

import torch

from perfbench import harness

SHRINK = {
    "folder": ({"per_species": 3, "calibration_per_species": 2}, {"batch_size": 4}),
    "request": ({"per_species": 2}, {}),
    "scan": ({"recordings": 2, "seconds": 30.0, "calls_per_recording": 4, "calibration_per_species": 1},
             {"batch_size": 8}),
    "train": ({"per_species": 2}, {}),
}
# the checked call lies past the learning rate's warm-up and inside the KL weight's ramp
TRAIN = {"batch_size": 2, "steps_a_call": 2, "checked_call_from_step": 5, "warmup_steps": 2, "kl_delay_steps": 2,
         "kl_warmup_steps": 8}


def manifest() -> dict:
    """BENCHMARK.json with the held-back cells and their metrics added."""
    m = harness.load_json(harness.ROOT / "BENCHMARK.json")
    held = harness.load_json(harness.PB / "held_back.json")
    for k in ("workloads", "end_to_end", "per_layer"):
        m[k] = m[k] + held[k]
    return m


def cell(name: str, m: dict = None, pb=harness.PB) -> harness.Cell:
    c = harness.load_cell(name, m or manifest(), pb)
    c.cfg = c.family.cpu_cut(c.cfg)
    mix, sess = SHRINK[c.kind]
    c.mix = dict(c.mix, **mix)
    c.workload = dict(c.workload, session=dict(c.workload["session"], **sess), warmup_calls=1)
    if "train" in c.workload:
        c.workload["train"] = dict(c.workload["train"], **TRAIN)
    return c


def run(c: harness.Cell, seed: int = 1234567890123, seconds: float = 0.2, trace: bool = False, m: dict = None):
    """-> (result dict, the stderr text) of one run on the CPU."""
    torch.manual_seed(0)
    out, err = io.StringIO(), io.StringIO()
    res = harness.run_cell(c.name, seed, seconds, trace, device="cpu", manifest=m or manifest(), cell=c,
                           out=out, err=err)
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == json.loads(json.dumps(res))
    return res, err.getvalue()
