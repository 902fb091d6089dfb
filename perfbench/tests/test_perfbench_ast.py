"""The ``ast`` encoder family (``perfbench/families/ast.py``): the port's config
object from the configuration, seeded weights under the port's own names,
the least work against a count by hand, the cut the CPU tests run, the
readers of the three attention / encoder metrics on a trace made by hand,
and a program without the AST encoder refused as the family loads."""

from __future__ import annotations

import dataclasses
import importlib.util

import pytest
import torch

from perfbench import devtrace, families, harness
from perfbench.reference import ast as ref_ast
from perfbench.tests import tiny
from perfbench.yardstick import flops, peaks

CFG = harness.load_config("ast-base-esc50")
FAM = families.of(CFG)
# by hand, at 128 mels x 501 frames: 12 x 49 = 588 patches, N = 590 tokens,
# D = 768, 12 heads of 64, MLP 3072, 12 blocks:
# 588·256·768 + 12·(N·D·3D + 2·N²·D + N·D·D + 2·N·D·3072)
MACS = 588 * 256 * 768 + 12 * (590 * 768 * 2304 + 2 * 590 * 590 * 768 + 590 * 768 * 768 + 2 * 590 * 768 * 3072)


def test_family_of_the_configuration():
    assert CFG["family"] == "ast" and FAM.__file__ == str(families.HERE / "ast.py")
    assert CFG["input_hw"] == [501, 128] and CFG["reduced"] == []


def test_program_config_fields():
    from anuraxla_torch.models.ast import ASTConfig

    got = FAM.program_config(CFG)
    assert type(got) is ASTConfig
    assert dataclasses.asdict(got) == dict(hidden=768, layers=12, heads=12, mlp=3072, patch=16, fstride=10,
                                           tstride=10, input_hw=(501, 128), layer_norm_eps=1e-6,
                                           dtype="float32")
    assert got.grid == (12, 49) and got.tokens == 590 and got.latent_dim == FAM.latent_dim(CFG) == 768


@pytest.mark.parametrize("cut", [False, True], ids=["published", "cpu_cut"])
def test_weights_are_named_as_the_port_s(cut):
    """The published widths by shape alone (the port's module built on the
    meta device), the cut by the weights drawn."""
    from anuraxla_torch.models.ast import ASTEncoder

    cfg = FAM.cpu_cut(CFG) if cut else CFG
    with torch.device("meta"):
        state = ASTEncoder(FAM.program_config(cfg)).state_dict()
    shapes = ref_ast.param_shapes(cfg)
    assert set(shapes) == set(state) and all(tuple(state[k].shape) == s for k, s in shapes.items())
    if cut:
        p = FAM.make_params(cfg, 2**31 + 11, torch.device("cpu"))
        assert list(p) == list(shapes) and all(v.dtype == torch.float32 for v in p.values())
    else:
        assert sum(torch.Size(s).numel() for s in shapes.values()) == 85_708_032  # 85.7 M parameters


def test_least_work_by_hand():
    assert FAM.encoder_macs(CFG) == MACS == 56_643_231_744
    from perfbench.yardstick import ast as yardstick

    assert yardstick.attention_flops(CFG) == 4 * 590**2 * 64 * 12 * 12 == 12_832_358_400
    assert yardstick.attention_bytes(CFG) == 4 * 590 * 768 * 2 * 12 == 43_499_520
    assert flops.chunk_flops(CFG) == flops.mel_flops_per_row(CFG["mel"]) + 2 * MACS
    assert flops.total_frames(CFG["mel"]) == CFG["mel"]["target_frames"] == 501


def test_cpu_cut_keeps_the_geometry():
    cut = FAM.cpu_cut(CFG)
    assert {k for k in cut if cut[k] != CFG[k]} == {"layers", "hidden", "heads", "mlp"}
    assert cut["hidden"] // cut["heads"] == CFG["hidden"] // CFG["heads"] == 64
    assert ref_ast.grid(cut) == ref_ast.grid(CFG) == (12, 49)
    assert tiny.cell("ast-scan-balanced").cfg == cut


def test_program_without_ast_is_refused_at_load(monkeypatch):
    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == FAM.PORT_MODULE else find(name, *a))
    with pytest.raises(SystemExit, match="no AST encoder"):
        families.load("ast")


def reading(trace):
    cell = tiny.cell("ast-scan-balanced")
    cell.cfg = CFG
    win = harness.Window(units=2880, seconds=1.0, calls=1, latencies=[1.0])
    return harness.Reading(cell, win, 0.0, trace, {}, {"chunks": 2880, "batches": 3, "attempted": 2880,
                                                       "failed": 0})


def test_readers_on_a_trace_by_hand():
    """Kernels launched inside ``anuraxla::attention`` (2 ms each, 36 of them)
    and inside ``anuraxla::encoder`` (the attention's and one 300 ms GEMM a
    batch); one kernel launched outside both is read by neither."""
    ms = 1_000_000
    ranges, device, launch = [], [], {}
    t = 0
    for b in range(3):
        ranges.append(("anuraxla::encoder", t, t + 400 * ms, 1))
        for i in range(12):
            a = t + (10 + 20 * i) * ms
            ranges.append(("anuraxla::attention", a, a + ms, 1))
            corr = 100 * b + i
            launch[corr] = (a + 1000, 1)
            device.append((a + ms, a + 3 * ms, "flash_fwd_kernel", "kernel", corr))
        launch[100 * b + 50] = (t + 300 * ms, 1)
        device.append((t + 300 * ms, t + 600 * ms, "gemm", "kernel", 100 * b + 50))
        t += 1000 * ms
    launch[999] = (t + 10, 1)
    device.append((t + 10, t + 20, "outside", "kernel", 999))
    tr = devtrace.Trace(window=(0, t + ms), device=device, launch=launch, ranges=ranges)
    r = reading(tr)
    assert harness.reader("attention_ms_per_batch")(r) == pytest.approx(24.0)
    least = 2880 * max(12_832_358_400 / peaks.BF16_FLOPS, 43_499_520 / peaks.HBM_BYTES_PER_S)
    assert harness.reader("attention_roofline")(r) == pytest.approx(100 * least / 0.072)
    assert harness.reader("encoder_roofline")(r) == pytest.approx(
        100 * 2880 * 2 * MACS / peaks.BF16_FLOPS / (0.072 + 0.9))
    empty = reading(devtrace.Trace(window=(0, t), device=[], launch={}, ranges=[]))
    assert all(harness.reader(m)(empty) is None
               for m in ("attention_ms_per_batch", "attention_roofline", "encoder_roofline"))
    assert all(harness.reader(m)(reading(None)) is None
               for m in ("attention_ms_per_batch", "attention_roofline", "encoder_roofline"))


def test_traced_tiny_run_reads_what_the_cpu_has():
    """On the CPU no kernel reaches the trace: the three readers find nothing
    and the line leaves them out; ``mfu_pct`` reads the family's count."""
    res, _ = tiny.run(tiny.cell("ast-scan-balanced"), seed=2**31 + 21, trace=True)
    assert res["correct"] is True and res["attempted"] > 0
    assert not {"attention_ms_per_batch", "attention_roofline", "encoder_roofline"} & set(res["metrics"])
    assert res["metrics"]["mfu_pct"]["value"] > 0
