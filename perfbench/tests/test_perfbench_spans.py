"""The metrics that read the program's spans (``source: program_span``): a
traced run of each cell on the CPU gives every one of them that the cell
reports, but the encoder's device time, which needs the card's kernels; the
spans on the prefetch thread count the window's chunks; an untraced run
gives none of them."""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.tests import tiny

CELLS = ("stride-folder-balanced", "avgpool-scan-balanced", "stride-request-parity")
SPAN_METRICS = {m["name"]: m for m in harness.load_json(harness.ROOT / "BENCHMARK.json")["per_layer"]
                if m["source"] == "program_span"}
DEVICE_ONLY = {"encoder_span_ms_per_batch"}


def test_ten_span_metrics():
    assert len(SPAN_METRICS) == 10
    assert {c for m in SPAN_METRICS.values() for c in m["workloads"]} == set(CELLS)


def spied_run(monkeypatch, name: str, trace: bool):
    """One tiny run of the cell; -> (result, the Reading its readers read)."""
    seen = {}
    orig = harness.reader

    def spy(metric):
        f = orig(metric)

        def read(r):
            seen["reading"] = r
            return f(r)

        return read

    monkeypatch.setattr(harness, "reader", spy)
    res, _ = tiny.run(tiny.cell(name), trace=trace)
    return res, seen["reading"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_every_span_metric(monkeypatch, name):
    from anuraxla_torch.utils import timing

    res, r = spied_run(monkeypatch, name, trace=True)
    assert res["correct"] is True
    mine = {m for m, e in SPAN_METRICS.items() if name in e["workloads"]}
    assert mine - DEVICE_ONLY <= set(res["metrics"]), sorted(mine - set(res["metrics"]))
    recs = timing.spans(*r.trace.window)
    assert recs, "no program span inside the window"
    if name == "stride-folder-balanced":
        decode = [x for x in recs if x.name == "decode"]
        assert sum(x.counts["files"] for x in decode) == r.counts["chunks"] == r.window.units
        assert len({x.thread for x in decode}) >= 1 and not {x.thread for x in decode} & {
            x.thread for x in recs if x.name == "fetch"}  # decoded on the prefetch thread
    if name == "avgpool-scan-balanced":
        extract = [x for x in recs if x.name == "extract"]
        assert sum(x.counts["windows"] for x in extract) == r.counts["chunks"] == r.window.units
        assert not {x.thread for x in extract} & {x.thread for x in recs if x.name == "fetch"}
    if name == "stride-request-parity":
        assert len([x for x in recs if x.name == "request"]) == r.counts["requests"]


@pytest.mark.parametrize("name", CELLS)
def test_untraced_run_gives_none(monkeypatch, name):
    res, r = spied_run(monkeypatch, name, trace=False)
    assert r.trace is None and not set(res["metrics"]) & set(SPAN_METRICS)
    for m in SPAN_METRICS:
        assert harness.reader(m)(r) is None, m
