"""On the card, at each cell's own size: a short run is correct, and the
control on three seeds is not. Skips without a card (decided in a fixture).

    python -m pytest -p no:cacheprovider -m cuda perfbench/tests/test_perfbench_cuda.py -q
"""

from __future__ import annotations

import io

import pytest
import torch

from perfbench import control, harness

M = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in M["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_card(card, name):
    res = harness.run_cell(name, 97531, 2.0, False, device="cuda", manifest=M, out=io.StringIO(), err=io.StringIO())
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_card(card, name):
    rows = control.control_readings(harness.load_cell(name, M), [101, 102, 103], card, out=io.StringIO())
    assert not any(r["correct"] for r in rows), rows
