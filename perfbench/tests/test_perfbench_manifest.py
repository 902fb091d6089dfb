"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, the files every entry names, and which cells report which metrics.
The held-back cells and metrics (``held_back.json``) are held to the same
form, with BENCHMARK.json's entries, so that moving them back needs no edit."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.tests import tiny

M = harness.load_json(harness.ROOT / "BENCHMARK.json")
ALL = tiny.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = [("end_to_end", m) for m in ALL["end_to_end"]] + [("per_layer", m) for m in ALL["per_layer"]]


def text_ok(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in M["paths"])
    assert 1 <= len(M["command"]) <= 32 and all(text_ok(w) and not w.startswith("/") and ".." not in w
                                                 for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M).encode()) <= 64 * 1024
    for p in M["paths"]:
        assert (harness.ROOT / p).is_dir()


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert text_ok(c["source"]) and c["source"].startswith("https://") and text_ok(c["why"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json" and (harness.ROOT / c["file"]).is_file()
        body = harness.load_json(harness.ROOT / c["file"])
        assert len(c["reduced"]) <= 16 and body["reduced"] == c["reduced"] and body["source"] == c["source"]
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])


@pytest.mark.parametrize("w", ALL["workloads"], ids=lambda w: w["name"])
def test_workload(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4) and text_ok(w["why"])
    cell = harness.load_cell(w["name"], ALL)
    assert (harness.PB / "drivers" / f"{cell.kind}.py").is_file()
    if cell.kind == "train":
        assert set(cell.workload["limits"]) == {"loss_gap", "grad_gap", "change_gap", "stretch_loss_gap",
                                                "stretch_change_gap"}
    else:
        assert set(cell.workload["limits"]) == {"dist_gap", "decisions_flipped", "rows_missing"}
        assert cell.workload["limits"]["decisions_flipped"] == 0 and cell.workload["limits"]["rows_missing"] == 0
    assert {cell.workload["control"]["mel"], cell.workload["control"]["trunk"]} <= {"tf32", "fp8"}
    e2e = harness.wanted_metrics(w["name"], ALL, False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert harness.wanted_metrics(w["name"], ALL, True)


def test_held_back_apart():
    """No held-back cell or metric is in BENCHMARK.json, and BENCHMARK.json's
    metrics name only its own cells."""
    held = harness.load_json(harness.PB / "held_back.json")
    assert set(held) == {"what", "workloads", "end_to_end", "per_layer"}
    for k in ("workloads", "end_to_end", "per_layer"):
        assert not {e["name"] for e in held[k]} & {e["name"] for e in M[k]}
    cells = {w["name"] for w in M["workloads"]}
    for m in M["end_to_end"] + M["per_layer"]:
        assert set(m.get("workloads", [])) <= cells, m["name"]


def test_cells_unique_and_four_chip_share():
    names = [w["name"] for w in M["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(names) // 4)


@pytest.mark.parametrize("kind,m", METRICS, ids=lambda x: x["name"] if isinstance(x, dict) else x)
def test_metric(kind, m):
    keys = {"name", "unit", "better", "source"} | ({"bound"} if kind == "end_to_end" else {"layer", "moves"})
    assert set(m) - {"workloads"} == keys
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES and harness.reader_path(m["name"]).is_file()
    cells = {w["name"] for w in ALL["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    if kind == "end_to_end":
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        assert text_ok(m["layer"]) and m["moves"] in {e["name"] for e in ALL["end_to_end"]}
        for cell in m.get("workloads", cells):
            assert m["moves"] in {e["name"] for e in harness.wanted_metrics(cell, ALL, False)}, cell
    if m["unit"] == "%" and m["name"].endswith("_roofline"):
        assert m["better"] == "higher"


def test_names_unique_and_layers_agree():
    names = [m["name"] for _, m in METRICS]
    assert len(names) == len(set(names)) and len(M["end_to_end"]) <= 16 and len(M["per_layer"]) <= 128
    assert "setup_s" in {m["name"] for m in M["end_to_end"]}
    assert next(m for m in M["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_files_under_paths_are_named_from_names():
    allowed = re.compile(r"^[A-Za-z0-9_./-]+$")
    for p in Path(harness.PB).rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert allowed.match(str(p.relative_to(harness.ROOT))), p
