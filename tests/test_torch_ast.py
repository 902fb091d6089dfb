"""The Audio Spectrogram Transformer encoder (``anuraxla_torch/models/ast.py``)
on the CPU: against the plain reference (``perfbench/reference/ast.py``) at a
cut width on seeded weights, in f32 and with a bf16 trunk (which the
reference computed one precision lower, fp8 operands, fails); served through
``EncoderSession`` (``encode_array``, a two-recording ``scan_soundscapes`` on
the span route, ``detect_species``, data shards); its refusals, spans,
counter, artifact, seeded fallback and cache key."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from anuraxla_torch.cli.evaluate_wav import detect_species
from anuraxla_torch.constants import MelConfig
from anuraxla_torch.detect.radial import radial_decide
from anuraxla_torch.config import priority_ranks
from anuraxla_torch.models import checkpoint
from anuraxla_torch.models.ast import ASTConfig, ASTEncoder, init_ast_params
from anuraxla_torch.models.vae import VAEConfig
from anuraxla_torch.parallel import mesh as t_mesh
from anuraxla_torch.pipeline import stream as t_stream
from anuraxla_torch.pipeline.session import EncoderSession, session_fingerprint
from anuraxla_torch.utils import timing
from anuraxla_torch.utils.wavio import write_wav
from perfbench.reference import ast as ref_ast
from perfbench.reference import lowp
from perfbench.reference import radial as ref_radial

# the benchmark configuration's geometry (128 mels x 501 frames: 12 x 49
# patches, 590 tokens, heads of 64) at the width the CPU runs in well under a second
CUT = dict(hidden=128, layers=2, heads=2, mlp=512, patch=16, fstride=10, tstride=10, layer_norm_eps=1e-6,
           input_hw=[501, 128])
# the port's f32 forward against the reference's: the convolution against the
# unfolded product, aten's LayerNorm and SDPA's math (the scale folded into Q)
# against the written-out ones sum in other orders; the widest gap seen over
# eight seeds is 10 float32 steps (2^-24) of the embedding's largest entry
F32_TOL = 32 * 2.0**-24
# a bf16 trunk (bf16 operands, f32 sums, f32 LayerNorm and softmax) reads
# 0.0037-0.0070 of the largest entry over the same seeds, the reference with
# fp8 operands 0.040-0.092: the tolerance lies between, with room on both sides
BF16_TOL = 0.02

SPECIES = ["Batrachyla_leptopus", "Batrachyla_taeniata", "Calyptocephalella_gayi", "Pleurodema_thaul"]
SR = 16000
SMALL = MelConfig(sr=SR, duration=0.5, n_mels=32, fmin=100.0, fmax=7500.0, hop_length=80, n_fft=256,
                  target_frames=101)
TINY = ASTConfig(hidden=64, layers=2, heads=1, mlp=128, input_hw=(101, 32))  # 2 x 9 patches, 20 tokens


def cut_cfg(dtype: str = "float32") -> ASTConfig:
    return ASTConfig(**{**CUT, "input_hw": tuple(CUT["input_hw"])}, dtype=dtype)


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def port(params, cfg: ASTConfig, x: torch.Tensor) -> torch.Tensor:
    enc = ASTEncoder(cfg)
    enc.load_state_dict(params)
    with torch.inference_mode():
        return enc.eval()(x[..., None])["mu"]


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_f32_matches_reference(seed):
    p = ref_ast.make_params(CUT, seed, torch.device("cpu"))
    x = torch.randn(3, 501, 128, generator=torch.Generator().manual_seed(seed + 1))
    got, want = port(p, cut_cfg(), x), ref_ast.encode(p, x, CUT)
    assert got.dtype == torch.float32 and got.shape == (3, 128)
    assert rel_gap(got, want) <= F32_TOL


@pytest.mark.parametrize("seed", [1, 2**31 + 8])
def test_bf16_trunk_matches_reference_and_fp8_does_not(seed):
    p = ref_ast.make_params(CUT, seed, torch.device("cpu"))
    x = torch.randn(3, 501, 128, generator=torch.Generator().manual_seed(seed + 1))
    want = ref_ast.encode(p, x, CUT)
    got = port(p, cut_cfg("bfloat16"), x)
    assert got.dtype == torch.float32 and rel_gap(got, want) <= BF16_TOL
    assert rel_gap(ref_ast.encode(p, x, CUT, rounding=lowp.ROUNDINGS["fp8"]), want) > BF16_TOL


def test_seeded_init_is_timm_s():
    cfg = cut_cfg()
    p = init_ast_params(cfg, torch.Generator().manual_seed(3))
    assert list(p) == list(ASTEncoder(cfg).state_dict()) and set(p) == set(ref_ast.param_shapes(CUT))
    assert all(tuple(p[k].shape) == s for k, s in ref_ast.param_shapes(CUT).items())
    assert torch.equal(p["blocks.1.norm2.weight"], torch.ones(128)) and not p["norm.bias"].any()
    assert not p["blocks.0.mlp.fc1.bias"].any()
    w = p["blocks.0.attn.qkv.weight"]
    assert 0.018 < float(w.std()) < 0.022 and float(w.abs().max()) < 0.2
    again = init_ast_params(cfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_spans_and_attention_counter():
    """``patch_embed`` once a forward, ``attention`` once a block, with their
    counts; the counter names the backend: math for an f32 trunk on the CPU,
    flash for a bf16 one."""
    p = init_ast_params(TINY, torch.Generator().manual_seed(0))
    x = torch.randn(3, 101, 32)
    for dtype, backend in (("float32", "math"), ("bfloat16", "flash")):
        n0 = dict(ASTEncoder.attention_calls)
        timing.clear_spans()
        try:
            with profile(activities=[ProfilerActivity.CPU]):
                port(p, dataclasses.replace(TINY, dtype=dtype), x)
            recs = timing.spans()
        finally:
            timing.clear_spans()
        got = {k: v - n0[k] for k, v in ASTEncoder.attention_calls.items()}
        assert got == {b: (TINY.layers if b == backend else 0) for b in got}
        assert [(r.name, r.counts) for r in recs if r.name in ("patch_embed", "attention")] == \
            [("patch_embed", {"rows": 3})] + [("attention", {"tokens": 3 * TINY.tokens})] * TINY.layers


def test_input_shape_checked():
    p = init_ast_params(TINY, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="expects input"):
        port(p, TINY, torch.randn(2, 100, 32))


def session(**kw) -> EncoderSession:
    params = kw.pop("params", None) or init_ast_params(TINY, torch.Generator().manual_seed(5))
    kw = {"mel": SMALL, "encoder_cfg": TINY, "backend": "matmul", "batch_size": 4, "device": "cpu", **kw}
    return EncoderSession(**kw).load(params=params)


def rows(n: int, seed: int = 0) -> np.ndarray:
    return (0.1 * np.random.default_rng(seed).standard_normal((n, SMALL.num_samples))).astype(np.float32)


def test_encode_array_is_the_encoder_on_the_session_mel():
    from anuraxla_torch.ops.frontend import log_mel_batch

    for dtype in ("float32", "bfloat16"):
        s = session(encoder_dtype=dtype)
        y = rows(5)
        z = s.encode_array(y)
        assert z.shape == (5, TINY.hidden) and s.latent_dim == TINY.hidden and z.dtype == np.float32
        with torch.inference_mode():
            mel = log_mel_batch(torch.from_numpy(y), SMALL, parity=True, backend="matmul")
            want = s._enc(mel[..., None])["mu"].numpy()
        np.testing.assert_array_equal(z, want)


def test_refusals_and_shards():
    with pytest.raises(ValueError, match="conv-VAE family only.*ASTConfig"):
        session(quantize=True)
    with pytest.raises(ValueError, match="expects input"):
        session(mel=dataclasses.replace(SMALL, n_mels=40))
    with pytest.raises(TypeError, match="no encoder serves"):
        session(encoder_cfg=dataclasses.replace(SMALL))
    y, want = rows(6, 1), session().encode_array(rows(6, 1))
    t_mesh.set_default_devices(["cpu"] * 2)
    try:
        dp = session(data_parallel=True)
        assert dp._mesh is not None and dp.batch_size == 4
        np.testing.assert_allclose(dp.encode_array(y), want, rtol=1e-5, atol=1e-6)
    finally:
        t_mesh.set_default_devices(None)


def write_pcm16(path, y: np.ndarray):
    write_wav(path, y, SR, subtype="PCM_16")
    return path


def radial_config(path, z: np.ndarray):
    """A radial block with one centroid a species, from the latents ``z``."""
    cfg = ref_radial.config_block(SPECIES, z[: len(SPECIES)], np.full(len(SPECIES), 1.5, np.float32),
                                  SMALL.duration)
    path.write_text(json.dumps(cfg))
    return cfg


def test_scan_and_detect_species(tmp_path):
    """A fleet of two PCM16 recordings at the mel rate takes the span route
    (every window cut on the device); each window's decision is the radial
    decision of its rows through ``encode_array``; ``detect_species`` answers
    as the decision of its WAV's latent."""
    s = session(normalize_on_device=True)
    rng = np.random.default_rng(4)
    recs = [(0.2 * rng.standard_normal(int(SR * sec))).astype(np.float32) for sec in (1.6, 2.1)]
    paths = [write_pcm16(tmp_path / f"r{i}.wav", y) for i, y in enumerate(recs)]
    cfg = radial_config(tmp_path / "config.json", s.encode_array(rows(4, 2)))
    per_file, stats = t_stream.scan_soundscapes(paths, s, detector="radial", config=cfg, hop_seconds=0.25,
                                                normalize=True, log=lambda *a: None)
    assert stats["n_windows"] == 7 + 9 and stats["windows_on_device"] == stats["n_windows"]
    centroids = np.stack([cfg["radial_detector"]["centroids"][sp] for sp in SPECIES]).astype(np.float32)
    thresholds = np.array([cfg["radial_detector"]["thresholds"][sp] for sp in SPECIES], np.float32)
    ranks = torch.from_numpy(priority_ranks(SPECIES))
    hop, L = SR // 4, SMALL.num_samples
    for p, y in zip(paths, recs):
        starts = range(0, len(y) - 1, hop)
        win = np.zeros((len(starts), L), np.float32)
        for j, a in enumerate(starts):
            w = np.round(y[a : a + L] * 32768).clip(-32768, 32767) / 32768  # the PCM16 samples
            win[j, : len(w)] = w
        det, idx, best = radial_decide(torch.from_numpy(s.encode_array(win)), torch.from_numpy(centroids),
                                       torch.from_numpy(thresholds), ranks)
        got = per_file[p]
        assert [d.t_start for d in got] == [a / SR for a in starts]
        assert [d.detected for d in got] == det.tolist()
        np.testing.assert_allclose([d.score for d in got], best.numpy(), rtol=1e-5, atol=1e-6)
    wav = write_pcm16(tmp_path / "one.wav", rows(1, 3)[0])
    detected, sp, best = detect_species(wav, s, tmp_path / "config.json")
    pcm = np.round(rows(1, 3) * 32768).clip(-32768, 32767).astype(np.float32) / 32768
    d, i, b = radial_decide(torch.from_numpy(s.encode_array(pcm)), torch.from_numpy(centroids),
                            torch.from_numpy(thresholds), ranks)
    assert (detected, sp) == (bool(d[0]), SPECIES[int(i[0])] if bool(d[0]) else None)
    assert best == pytest.approx(float(b[0]), rel=1e-5, abs=1e-6)


def test_artifact_round_trip_and_fallback(tmp_path, caplog):
    """``encoder.json`` names the family (``"arch": "ast"``), the msgpack holds
    the port's own names; ``encoder_dir``, the project's default artifact and
    ``load_or_init_encoder`` serve it as they serve a conv artifact; with no
    artifact an AST config gets the seeded timm init."""
    cfg = dataclasses.replace(TINY, dtype="bfloat16")
    state = ref_ast.make_params({**dataclasses.asdict(TINY), "input_hw": list(TINY.input_hw)}, 9,
                                torch.device("cpu"))
    d = checkpoint.save_encoder(tmp_path / "enc", cfg, state)
    meta = json.loads((d / "encoder.json").read_text())
    assert meta["arch"] == "ast" and meta["input_hw"] == [101, 32] and meta["dtype"] == "bfloat16"
    back, bcfg = checkpoint.load_encoder(d)
    assert bcfg == cfg and list(back) == list(state) and all(torch.equal(back[k], state[k]) for k in state)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "encoder.json").write_text(json.dumps({**meta, "arch": "cnn14"}))
    with pytest.raises(ValueError, match="arch 'cnn14'"):
        checkpoint.load_encoder(bad)
    want = session(params=state).encode_array(rows(3))
    by_dir = EncoderSession(mel=SMALL, backend="matmul", device="cpu", encoder_dir=d).load()
    assert isinstance(by_dir._enc, ASTEncoder) and by_dir.encoder_cfg == cfg
    np.testing.assert_array_equal(by_dir.encode_array(rows(3)), want)
    project = tmp_path / "project"
    checkpoint.save_encoder(checkpoint.default_encoder_artifact(project), TINY, state)
    by_root = EncoderSession(mel=SMALL, backend="matmul", device="cpu", project_root=project).load()
    np.testing.assert_array_equal(by_root.encode_array(rows(3)), want)
    with caplog.at_level("WARNING"):
        init, icfg = checkpoint.load_or_init_encoder(None, tmp_path / "empty", seed=4, cfg=TINY)
    assert icfg is TINY and "seeded random init" in caplog.text
    seeded = init_ast_params(TINY, torch.Generator().manual_seed(4))
    assert list(init) == list(seeded) and all(torch.equal(init[k], seeded[k]) for k in init)


def test_fingerprint_names_the_family():
    conv = EncoderSession(mel=SMALL, backend="matmul", device="cpu", encoder_cfg=VAEConfig(input_hw=(101, 32)))
    keys = {session_fingerprint(session()), session_fingerprint(session(encoder_dtype="bfloat16")),
            session_fingerprint(conv.load())}
    assert len(keys) == 3
    assert checkpoint.cfg_to_dict(TINY)["arch"] == "ast" and "arch" not in checkpoint.cfg_to_dict(VAEConfig())
