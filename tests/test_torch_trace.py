"""The port's spans (``anuraxla_torch.utils.timing``): nothing recorded and no
profiler range opened while no profiler runs; records from worker threads
with their thread, parent and counts; the profiler's clock; the spans of the
served paths (``encode_paths``, ``detect_species``); the buffer's bound.
Everything runs on the CPU under ``torch.profiler`` at tiny shapes."""

from __future__ import annotations

import json
import statistics
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from anuraxla_torch.cli import evaluate_wav
from anuraxla_torch.constants import PRIORITY_ORDER, MelConfig
from anuraxla_torch.models.vae import VAEConfig
from anuraxla_torch.pipeline.session import EncoderSession
from anuraxla_torch.utils import timing
from anuraxla_torch.utils.wavio import write_wav

SMALL = MelConfig(sr=16000, duration=0.5, hop_length=128, n_fft=256, n_mels=32, target_frames=48)
NARROW = VAEConfig(latent_dim=8, widths=(8, 16), dense_width=32, groups=4, input_hw=(48, 32))


@pytest.fixture(autouse=True)
def empty_buffer():
    timing.clear_spans()
    yield
    timing.clear_spans()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def write_wavs(d: Path, n: int) -> list:
    rng = np.random.default_rng(5)
    paths = []
    for i in range(n):
        p = d / f"c{i}.wav"
        write_wav(p, (0.2 * rng.standard_normal(SMALL.num_samples)).astype(np.float32), SMALL.sr)
        paths.append(p)
    return paths


def session(batch_size: int) -> EncoderSession:
    return EncoderSession(mel=SMALL, device="cpu", encoder_cfg=NARROW, batch_size=batch_size, num_threads=2).load()


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("touched while no profiler runs")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", refuse)
    monkeypatch.setattr(timing, "_clock", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = timing.span("decode", files=3), timing.span("fetch", id=7)
    assert a is b  # the one shared no-op: no object is made
    with a as s:
        s["failed"] = 1
        with timing.span("inner"):
            pass
    assert timing.spans() == [] and timing.dropped() == 0


def test_worker_thread_span_recorded():
    def work():
        with timing.span("extract", id=16, windows=8) as outer:
            with timing.span("inner") as inner:
                inner["bytes"] = 64
            outer["windows"] = 9
        return threading.get_native_id(), torch.autograd._profiler_enabled()

    with cpu_profile():
        with ThreadPoolExecutor(max_workers=1) as ex:
            tid, seen = ex.submit(work).result()
    assert not seen  # the profiler does not record the pool's thread: only the program's records see it
    recs = {r.name: r for r in timing.spans()}
    assert set(recs) == {"extract", "inner"}
    outer, inner = recs["extract"], recs["inner"]
    assert outer.thread == inner.thread == tid != threading.get_native_id()
    assert outer.parent is None and inner.parent == outer.seq
    assert outer.counts == {"windows": 9} and inner.counts == {"bytes": 64}
    assert outer.id == inner.id == 16  # inherited from the parent
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_threads_share_the_buffer(monkeypatch):
    """More threads than cores, switching often: no record lost or doubled,
    every parent on its own thread, and a full buffer's count exact."""
    threads, pairs = 16, 150
    monkeypatch.setattr(timing, "SPAN_CAPACITY", threads * pairs)  # room for the outer spans alone

    def work(k):
        for i in range(pairs):
            with timing.span("outer", id=k * pairs + i):
                with timing.span("inner", k=k):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cpu_profile():
            with ThreadPoolExecutor(max_workers=threads) as ex:
                for fut in [ex.submit(work, k) for k in range(threads)]:
                    fut.result(timeout=120)
    finally:
        sys.setswitchinterval(old)
    kept = timing._kept(None, None)
    assert len(kept) == threads * pairs and timing.dropped() == threads * pairs
    assert len({r.seq for r in kept}) == len(kept)
    outer = {r.seq: r for r in kept if r.name == "outer"}
    for r in kept:
        if r.name == "inner" and r.parent in outer:
            assert outer[r.parent].thread == r.thread and outer[r.parent].id == r.id


def test_spans_share_the_profilers_clock():
    with cpu_profile() as prof:
        with timing.span("warm"):
            pass
        for i in range(20):
            with timing.span(f"clock{i}"):
                time.sleep(0.0003)
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(timing.SPAN_PREFIX + "clock")}
    recs = [r for r in timing.spans() if r.name.startswith("clock")]
    assert len(recs) == len(ranges) == 20
    diffs = []
    for r in recs:
        ev = ranges[timing.SPAN_PREFIX + r.name]
        diffs += [abs(r.start_ns - ev.start_ns()), abs(r.end_ns - (ev.start_ns() + ev.duration_ns()))]
    assert max(diffs) < 1_000_000, diffs
    assert statistics.median(diffs) < 50_000, diffs


def test_encode_paths_spans(tmp_path):
    paths = write_wavs(tmp_path, 5)
    s = session(2)
    s.encode_paths(paths)  # warm
    with cpu_profile():
        Z, ok, _ = s.encode_paths(paths)
    assert ok.all() and Z.shape == (5, 8)
    recs = timing.spans()
    by = {n: [r for r in recs if r.name == n] for n in ("decode", "input_wait", "slot_wait", "fetch", "dispatch",
                                                      "encoder")}
    assert len(by["decode"]) == 3 and sum(r.counts["files"] for r in by["decode"]) == 5
    assert all(r.counts["failed"] == 0 for r in by["decode"])
    assert [r.id for r in by["input_wait"]] == [0, 2, 4]  # one a consumed batch, on the consumer's thread
    assert len(by["slot_wait"]) == 3  # one a claim of the ring, on the prefetch thread
    assert {r.thread for r in by["slot_wait"]} == {r.thread for r in by["decode"]} != {threading.get_native_id()}
    assert [(r.id, r.counts["rows"]) for r in by["fetch"]] == [(0, 2), (2, 2), (4, 1)]
    assert len(by["dispatch"]) == len(by["encoder"]) == 3
    seq = {r.seq: r for r in recs}
    assert all(seq[r.parent].name == "dispatch" for r in by["encoder"])
    assert not any(r.name == "stage" for r in recs)  # decoded straight into the ring's slots


def test_detect_species_spans_share_its_id(tmp_path):
    paths = write_wavs(tmp_path, 2)
    s = session(1)
    z = s.encode_array(np.stack([np.zeros(SMALL.num_samples, np.float32)]))[0]
    sp = PRIORITY_ORDER[0]
    cfg = {"species": [sp], "chunk_seconds": SMALL.duration,
           "radial_detector": {"centroids": {sp: z.tolist()}, "thresholds": {sp: 1.0}}}
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    evaluate_wav.detect_species(paths[0], s, cfg_path)  # warm
    with cpu_profile():
        for p in paths:
            evaluate_wav.detect_species(p, s, cfg_path)
    recs = timing.spans()
    requests = [r for r in recs if r.name == "request"]
    assert len(requests) == 2 and requests[0].id + 1 == requests[1].id
    for req in requests:
        mine = [r for r in recs if r.id == req.id]
        assert {r.name for r in mine} == {"request", "config_read", "decode", "dispatch", "slot_wait", "stage",
                                          "encoder", "fetch"}
        assert all(req.start_ns <= r.start_ns <= r.end_ns <= req.end_ns for r in mine)


def test_full_buffer_counts_its_drops(monkeypatch):
    monkeypatch.setattr(timing, "SPAN_CAPACITY", 4)
    with cpu_profile():
        t0 = time.time_ns()
        for _ in range(3):
            with timing.span("a"):
                pass
        t1 = time.time_ns()
        for _ in range(4):
            with timing.span("b"):
                pass
    assert timing.dropped() == 3
    assert len(timing.spans(t0, t1)) == 3  # the interval closed before the first refusal
    assert timing.spans(t0) is None  # a refused record may lie there
    timing.clear_spans()
    assert timing.dropped() == 0 and timing.spans() == []


def test_maybe_trace_writes_spans_and_nests(tmp_path, monkeypatch):
    monkeypatch.setenv("ANURAXLA_TRACE_DIR", str(tmp_path))
    with timing.maybe_trace("region"):
        with timing.span("decode", files=2):
            pass
    lines = [json.loads(x) for x in (tmp_path / "region" / "spans.jsonl").read_text().splitlines()]
    assert (tmp_path / "region" / "trace.json").is_file()
    assert [(x["name"], x["counts"]) for x in lines] == [("decode", {"files": 2})]
    assert timing.spans() == []  # exported, then cleared
    with cpu_profile():  # a profiler already runs: no second one, nothing written
        with timing.maybe_trace("nested"):
            with timing.span("fetch"):
                pass
    assert not (tmp_path / "nested").exists() and [r.name for r in timing.spans()] == ["fetch"]
