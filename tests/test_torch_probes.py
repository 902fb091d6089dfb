"""The port's probes and bench on the CPU: each ``main`` at a small config
prints well-formed JSON lines with the documented keys (the times are host
times of the plain versions and are not looked at), the fused variants agree
with the non-fused exact baseline within the gates, and ``adaptive_rate``
converges on a steady ``run_group`` and says so when it cannot.

Gates on ``max_rel_err_vs_baseline`` (largest difference of each row's max):
fused exact 2e-5 (the exact tier's gate); the bf16 modes 5e-3, the JAX
suite's gate for a bf16 mode against the exact kernel
(test_pallas_frontend.py:351)."""

import json
import time

import numpy as np
import pytest

from anuraxla_torch import bench
from anuraxla_torch.constants import DEFAULT_MEL
from anuraxla_torch.models.vae import VAEConfig
from anuraxla_torch.ops import mel_kernel as tk
from anuraxla_torch.probes import common, kernel_ablation, kernel_variants, phase_variants, profile_stages

# MelConfig(sr=48000, duration=1.0, n_mels=64, fmin=150, fmax=15000, hop 384, n_fft 2048, target_frames=96)
SMALL = ["--device", "cpu", "--batch", "2", "--measure-s", "0", "--duration", "1.0", "--target-frames", "96"]


def _lines(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return [json.loads(line) for line in out]


def _check_header(head, batch=2):
    assert head["device"] == "cpu" and head["card"] is None and "not a device metric" in head["note"]
    assert head["batch"] == batch and head["frames"] == 126


@pytest.mark.parametrize("hop", [384, 320])
def test_kernel_variants(capsys, hop):
    before = dict(tk.mel_power.launches)
    kernel_variants.main(SMALL + ["--bf16", "--hop-length", str(hop)])
    head, *rows = _lines(capsys)
    assert head["hop"] == hop and head["device"] == "cpu"
    assert [(r["fused"], r["exact"]) for r in rows] == [(False, True), (False, False), (True, True), (True, False)]
    for r in rows:
        assert set(r) == {"fused", "exact", "ms_per_batch", "chunks_per_s", "max_rel_err_vs_baseline"}
        assert r["ms_per_batch"] > 0 and np.isclose(r["chunks_per_s"], 2 / r["ms_per_batch"] * 1e3)
        assert r["max_rel_err_vs_baseline"] <= (2e-5 if r["exact"] else 5e-3)
    assert rows[0]["max_rel_err_vs_baseline"] == 0.0 and rows[2]["max_rel_err_vs_baseline"] > 0
    assert tk.mel_power.launches == before  # the CPU runs the plain versions


def test_phase_variants(capsys):
    phase_variants.main(SMALL)
    head, *rows = _lines(capsys)
    _check_header(head)
    assert head["pre_padded"] is True
    assert [r["variant"] for r in rows] == ["fused=False", "fused=True"]
    for r in rows:
        assert set(r) == {"variant", "ms_per_batch", "chunks_per_s", "max_rel_err_vs_first"}
        assert r["ms_per_batch"] > 0 and r["max_rel_err_vs_first"] <= 2e-5


@pytest.mark.parametrize("bf16", [False, True], ids=["exact", "bf16"])
def test_kernel_ablation(capsys, bf16):
    kernel_ablation.main(SMALL + (["--bf16"] if bf16 else []))
    head, *rows = _lines(capsys)
    _check_header(head)
    assert head["exact"] is (not bf16)
    names = (["baseline", "no-window", "no-inner", "no-power", "no-fb"] + ([] if bf16 else ["no-splits", "no-dots"])
             + ["floor", "baseline-close"])
    n = len(names)
    assert [r["variant"] for r in rows[:n]] == names and all(r["ms_per_batch"] > 0 for r in rows[:n])
    bracket = rows[n]["baseline_bracket_ms"]
    assert bracket == [rows[0]["ms_per_batch"], rows[n - 1]["ms_per_batch"]]
    deltas = rows[n + 1 :]
    assert [r["variant"] for r in deltas] == names[1:-1]
    mean = sum(bracket) / 2
    for r, timed in zip(deltas, rows[1 : n - 1]):
        assert np.isclose(r["delta_ms_vs_baseline"], mean - timed["ms_per_batch"])
        assert np.isclose(r["pct_of_baseline"], r["delta_ms_vs_baseline"] / mean * 100)


def test_kernel_ablation_refuses_where_the_kernel_does():
    with pytest.raises(NotImplementedError, match="hop % 128"):  # no pre-padded layout, no ablation
        kernel_ablation.main(SMALL + ["--hop-length", "320"])


def test_profile_stages(capsys):
    profile_stages.main(SMALL)
    head, *rows = _lines(capsys)
    _check_header(head)
    assert [r["stage"] for r in rows] == ["full", "melpow", "frontend", "encoder", "detect"]
    for r in rows:
        assert set(r) == {"stage", "ms_per_batch", "chunks_per_s"} and r["ms_per_batch"] > 0


def test_probes_default_to_the_card():
    """No ``--device``: the probes ask for the card and raise where there is none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this check is for a host without a card")
    for main in (kernel_variants.main, phase_variants.main, kernel_ablation.main, profile_stages.main, bench.main):
        with pytest.raises(RuntimeError, match="device='cuda'"):
            main(["--batch", "2"])


def test_bench_main(capsys):
    bench.main(SMALL)
    (rec,) = _lines(capsys)
    assert rec["metric"] == "chunks_encoded_detected_per_sec_per_card" and rec["unit"] == "chunks/s"
    assert rec["device"] == "cpu" and rec["card"] is None and rec["batch"] == 2
    assert "vs_baseline" not in rec
    legs = {"balanced", "f32_encoder", "fast_tier"}
    assert set(rec["windows"]) == set(rec["converged"]) == legs
    for key in ("value", "value_f32_encoder", "value_fast_tier"):
        assert rec[key] > 0
    assert all(len(w) >= 2 and min(w) > 0 for w in rec["windows"].values())
    assert rec["peak_tflops_bf16_h100"] == 989.0 and "peak_tflops_fp32_h100" not in rec
    assert rec["fast_tier_backend"] == "cuda-bf16"


def test_pipeline_flops_accountings():
    fl = bench.pipeline_flops(DEFAULT_MEL, VAEConfig())
    n_freq = 1025
    enc = fl["dense_equiv"] - 626 * 2 * (2 * 2048 * n_freq + n_freq * 64)
    # the exact kernel's mma form: 64-frame tiles (640 frames), three bf16 passes, per r the
    # products of a_re (and a_im) into x_re and x_im, then the power against the merged filterbank
    assert enc > 0 and fl["kernel_actual"] - enc == 640 * 2 * 3 * (
        7 * (4 * 128 * 128 + 128 * 64) + 2 * (2 * 128 * 128 + 128 * 64))
    assert fl["kernel_actual"] - enc == bench.ct_mma_flops(DEFAULT_MEL, 1, 640, exact=True)
    assert fl["kernel_actual"] < fl["dense_equiv"]


def test_make_audio_is_seeded():
    a, b = bench.make_audio(3, 4800), bench.make_audio(3, 4800)
    assert a.dtype == np.float32 and a.shape == (3, 4800) and np.array_equal(a, b)
    assert not np.array_equal(a[0], a[1])


def test_adaptive_rate_converges_on_a_constant_rate():
    calls = []

    def run_group():
        time.sleep(0.004)
        calls.append(1)
        return 1.0

    rate, windows, converged = bench.adaptive_rate(run_group, 10.0, window_s=0.05, max_s=5.0)
    assert converged and len(windows) >= 2
    assert abs(windows[-1] - windows[-2]) / max(windows[-2:]) <= bench.WINDOW_TOL
    assert rate == (windows[-1] + windows[-2]) / 2
    assert 10.0 / 0.02 < rate <= 10.0 / 0.004  # 10 units per >= 4 ms group


def test_adaptive_rate_flags_a_drifting_rate():
    delay = [0.002]

    def run_group():
        delay[0] *= 1.25  # every group slower than the last: no two windows agree
        time.sleep(delay[0])
        return 1.0

    rate, windows, converged = bench.adaptive_rate(run_group, 1.0, window_s=0.01, max_s=0.4)
    assert not converged and rate == max(windows) and len(windows) >= 2


def test_measure_ms_counts_whole_groups():
    calls = []
    ms = common.measure_ms(lambda x: calls.append(x), 7, measure_s=0.0, device="cpu")
    assert calls == [7] * (1 + common.GROUP) and ms >= 0
