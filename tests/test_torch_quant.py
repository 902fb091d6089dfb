"""The port's int8 serving (``anuraxla_torch.models.quant``, ``ops/int8.py``)
held against the JAX package's ``anuraxla.models.quant`` on the CPU, where
the port's contractions run their plain versions.

What is bitwise: the quantized weights and their scales, every int8
activation code and int32 sum computed from the same float input, and the
dequantizing epilogue. What is not: GroupNorm and the activation are f32
sums and transcendentals in another order, a few ulps apart, and an
activation whose x / sx sits within those ulps of a half-integer rounds to
the neighbouring code. With per-row dynamic scales such a flip moves that
row's later layers and can flip more codes (the reference's own jit and
eager runs disagree the same way). So the whole-encoder comparison is made
twice: in lock step — every code where the two packages differ must be such
a tie (their x / sx within TIE_QUANTA of each other), the port then takes
the reference's code — held to 1e-3 of each row's max and cosine >= 0.9999;
and free running, held to the bound measured by ``PYTHONPATH=. python
tests/test_torch_quant.py`` from the repository's root (FREE_* below).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anuraxla.models import quant as jq
from anuraxla.models.vae import VAEConfig as JCfg
from anuraxla.models.vae import init_encoder
from anuraxla_torch.models import quant as tq
from anuraxla_torch.models.convert import encoder_params_for_jax, encoder_state_from_jax
from anuraxla_torch.models.vae import ConvVAEEncoder, VAEConfig
from anuraxla_torch.ops import int8 as ti8

SMALL = dict(widths=(8, 16), dense_width=24, latent_dim=12, input_hw=(48, 32), groups=4)
FAMILIES = {
    "stride": {},
    "avgpool": dict(downsample="avgpool"),
    "torch_padding": dict(conv_padding="TORCH", gn_eps=1e-5),
}
TIE_QUANTA = 1e-3  # |x/sx| apart, in quanta, where the two packages may round to neighbouring codes
# free running, port vs the reference (eager), each row: measured by this
# file's __main__ (24 seeds) over 96 rows of the default VAEConfig and 192 of
# each small family: largest 0.05542 of a row's max (the reference's jit
# against its own eager forward: 0.0557), smallest cosine 0.998582; median
# 0.023 at full width, 1.5e-7 on the small families. Gated at 1.8x / 2.1x
FREE_REL = 0.1
FREE_COS = 0.997


def _cfgs(family: str, full: bool = False):
    kw = dict(FAMILIES[family], **({} if full else SMALL))
    return JCfg(**kw), VAEConfig(**kw)


def _params(jcfg, tcfg, seed):
    _, params = init_encoder(jcfg, seed=seed)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    return params, encoder_state_from_jax(pnp, tcfg)


@pytest.fixture(scope="module")
def full():
    """The default VAEConfig ([192, 64] -> 128, widths 32..256, dense 512),
    JAX's seeded init, and its state_dict for the port."""
    jcfg, tcfg = _cfgs("stride", full=True)
    params, sd = _params(jcfg, tcfg, 0)
    return jcfg, tcfg, params, sd


def _mel(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal((b, *cfg.input_hw, 1)).astype(np.float32)


def _row_rel(ref, got):
    return np.abs(ref - got).max(-1) / np.abs(ref).max(-1)


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _assert_tree(qj, qt, *, act_rtol):
    assert set(qj) == set(qt)
    for name, c in qj["conv"].items():
        t = qt["conv"][name]
        assert t["wq"].dtype == torch.int8 and t["wq"].shape == tuple(c["wq"].shape)
        assert np.array_equal(np.asarray(c["wq"]), t["wq"].numpy()), name
        assert np.array_equal(np.asarray(c["sw"]), t["sw"].numpy()), name
        assert np.array_equal(np.asarray(c["bias"]), t["bias"].numpy()), name
    assert set(qj["gn"]) == set(qt["gn"]) and set(qj["act_scale"]) == set(qt["act_scale"])
    for name, g in qj["gn"].items():
        for k in ("scale", "bias"):
            assert np.array_equal(np.asarray(g[k]), qt["gn"][name][k].numpy())
    for name, head in qj["f32"].items():
        for k in ("kernel", "bias"):
            assert np.array_equal(np.asarray(head[k]), qt["f32"][name][k].numpy())
    for name, s in qj["act_scale"].items():
        # the calibration pass's absmax after f32 layers summed in another order
        np.testing.assert_allclose(float(qt["act_scale"][name]), float(s), rtol=act_rtol)


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
def test_quantized_tree_bitwise_default_config(full, calibrated):
    jcfg, tcfg, params, sd = full
    x = _mel(jcfg, 3, 1) if calibrated else None
    qj = jq.quantize_encoder(params, jcfg, None if x is None else jnp.asarray(x))
    qt = tq.quantize_encoder(sd, tcfg, None if x is None else torch.from_numpy(x), device="cpu")
    _assert_tree(qj, qt, act_rtol=1e-5)
    assert qt["conv"]["Dense_0"]["wq"].shape == (12288, 512)


@pytest.mark.parametrize("family", ["avgpool", "torch_padding"])
def test_quantized_tree_bitwise_families(family):
    jcfg, tcfg = _cfgs(family)
    params, sd = _params(jcfg, tcfg, 2)
    x = _mel(jcfg, 4, 3)
    qj = jq.quantize_encoder(params, jcfg, jnp.asarray(x))
    # the JAX layout goes in as well as the state_dict
    tree = jax.tree_util.tree_map(np.asarray, params)
    for p in (sd, tree, encoder_params_for_jax(sd, tcfg)):
        _assert_tree(qj, tq.quantize_encoder(p, tcfg, torch.from_numpy(x), device="cpu"), act_rtol=1e-5)


def test_first_conv_codes_and_int32_bitwise(full):
    """The first conv's per-row scales, int8 input and int32 output equal the
    reference's ``_int8_conv`` bit for bit, and so does its epilogue."""
    jcfg, tcfg, params, sd = full
    qj, qt = jq.quantize_encoder(params, jcfg), tq.quantize_encoder(sd, tcfg, device="cpu")
    x = _mel(jcfg, 3, 4)
    name = "EncoderBlock_0/Conv_0"
    xj = jnp.asarray(x)
    sxj = jnp.maximum(jnp.max(jnp.abs(xj), axis=(1, 2, 3), keepdims=True) / 127.0, 1e-12)
    xqj = jq._quant_x(xj, sxj)
    pads = jq._conv_pads(jcfg, 192, 64, 2)
    assert tq._conv_pads(tcfg, 192, 64, 2) == pads == ((0, 1), (0, 1))
    yj = jq._int8_conv(xqj, qj["conv"][name]["wq"], 2, pads)
    c = qj["conv"][name]
    fj = yj.astype(jnp.float32) * (sxj * c["sw"]) + c["bias"]

    xt = torch.from_numpy(x)
    sxt = tq._act_scale(qt, name, xt)
    xqt = tq._quant_x(xt, sxt)
    ct = qt["conv"][name]
    assert np.array_equal(sxt.numpy(), np.asarray(sxj))
    assert xqt.dtype == torch.int8 and np.array_equal(xqt.numpy(), np.asarray(xqj))
    raw = ti8.int8_conv(xqt, ct["wq"], sxt, ct["sw"], ct["bias"], 2, pads, raw=True)
    assert raw.dtype == torch.int32 and np.array_equal(raw.numpy(), np.asarray(yj))
    out = ti8.int8_conv(xqt, ct["wq"], sxt, ct["sw"], ct["bias"], 2, pads)
    assert np.array_equal(out.numpy(), np.asarray(fj))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_f32_matches_jax(family):
    jcfg, tcfg = _cfgs(family)
    params, sd = _params(jcfg, tcfg, 1)
    x = _mel(jcfg, 3, 5)
    ref = np.asarray(jq.encoder_forward_f32(params, jcfg, jnp.asarray(x)))
    got = tq.encoder_forward_f32(sd, tcfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)  # tests/test_quant.py:27
    # and the twin is the port's own module
    enc = ConvVAEEncoder(tcfg)
    enc.load_state_dict(sd)
    np.testing.assert_allclose(got, enc(torch.from_numpy(x))["mu"].detach().numpy(), atol=2e-4, rtol=1e-4)


def lockstep(qj, jcfg, qt, tcfg, x, monkeypatch):
    """Both packages' ``encoder_apply_quantized`` on ``x`` in lock step: the
    reference's codes are recorded layer by layer, and at each layer the port
    computes its own, which must differ only at ties, then continues with the
    reference's. -> (reference mu, port mu, codes that differed)."""
    seen = []
    j_quant = jq._quant_x

    def record(v, sx):
        q = j_quant(v, sx)
        seen.append((np.asarray(v) / np.asarray(sx), np.asarray(q)))
        return q

    monkeypatch.setattr(jq, "_quant_x", record)
    ref = np.asarray(jq.encoder_apply_quantized(qj, jcfg, jnp.asarray(x))["mu"])
    t_quant, flips, layer = tq._quant_x, [], iter(seen)

    def replay(v, sx):
        u_ref, q_ref = next(layer)
        q = t_quant(v, sx).numpy()
        u = (v / sx).numpy()
        assert np.abs(u - u_ref).max() <= TIE_QUANTA  # the float paths agree to a small part of a quantum
        differ = q != q_ref
        flips.append(int(differ.sum()))
        return torch.from_numpy(q_ref.copy())

    monkeypatch.setattr(tq, "_quant_x", replay)
    got = tq.encoder_apply_quantized(qt, tcfg, torch.from_numpy(x))["mu"].numpy()
    assert len(flips) == len(seen)
    return ref, got, flips


@pytest.mark.parametrize("family", ["stride", "avgpool"])
def test_apply_quantized_lockstep_matches_jax(family, full, monkeypatch):
    if family == "stride":
        jcfg, tcfg, params, sd = full
    else:
        jcfg, tcfg = _cfgs(family)
        params, sd = _params(jcfg, tcfg, 2)
    qj, qt = jq.quantize_encoder(params, jcfg), tq.quantize_encoder(sd, tcfg, device="cpu")
    x = _mel(jcfg, 4, 6)
    ref, got, _ = lockstep(qj, jcfg, qt, tcfg, x, monkeypatch)
    assert _row_rel(ref, got).max() <= 1e-3
    assert _cos(ref, got).min() >= 0.9999


@pytest.mark.parametrize("family", ["stride", "avgpool"])
def test_apply_quantized_free_running_vs_jax(family, full):
    if family == "stride":
        jcfg, tcfg, params, sd = full
    else:
        jcfg, tcfg = _cfgs(family)
        params, sd = _params(jcfg, tcfg, 2)
    qj, qt = jq.quantize_encoder(params, jcfg), tq.quantize_encoder(sd, tcfg, device="cpu")
    x = _mel(jcfg, 4, 7)
    ref = np.asarray(jq.encoder_apply_quantized(qj, jcfg, jnp.asarray(x))["mu"])
    out = tq.encoder_apply_quantized(qt, tcfg, torch.from_numpy(x))
    got = out["mu"].numpy()
    assert out["z"] is out["mu"]
    assert _row_rel(ref, got).max() <= FREE_REL
    assert _cos(ref, got).min() >= FREE_COS


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
@pytest.mark.parametrize("family", ["stride", "avgpool"])
def test_quantization_drift_vs_f32(family, calibrated):
    """The reference's post-training-quantization gates (tests/test_quant.py:
    per-row cosine > 0.97, relative L2 < 0.25 against the f32 latents)."""
    jcfg, tcfg = _cfgs(family)
    _, sd = _params(jcfg, tcfg, 0)
    x = torch.from_numpy(_mel(jcfg, 6, 8))
    enc = ConvVAEEncoder(tcfg)
    enc.load_state_dict(sd)
    mu_f = enc(x)["mu"].detach().numpy()
    q = tq.quantize_encoder(sd, tcfg, x if calibrated else None, device="cpu")
    assert bool(q["act_scale"]) == calibrated
    mu_q = tq.encoder_apply_quantized(q, tcfg, x)["mu"].numpy()
    assert _cos(mu_f, mu_q).min() > 0.97
    assert (np.linalg.norm(mu_q - mu_f, axis=-1) / np.linalg.norm(mu_f, axis=-1)).max() < 0.25


def test_uncalibrated_latents_independent_of_batch_mates(full):
    """Per-row scales: a row's latent is the same alone and beside loud
    batch-mates (tests/test_quant.py:62, atol 1e-5)."""
    _, tcfg, _, sd = full
    q = tq.quantize_encoder(sd, tcfg, device="cpu")
    x = _mel(tcfg, 4, 9)
    loud = 50.0 * _mel(tcfg, 3, 10)
    alone = tq.encoder_apply_quantized(q, tcfg, torch.from_numpy(x[:1]))["mu"].numpy()
    mixed = tq.encoder_apply_quantized(q, tcfg, torch.from_numpy(np.concatenate([x[:1], loud])))["mu"].numpy()
    np.testing.assert_allclose(mixed[0], alone[0], atol=1e-5, rtol=0)


def test_quantize_ingested_avgpool_checkpoint(tmp_path):
    """tests/test_quant.py:126 on the port: a pickled torch avgpool encoder
    ingested by the port's hydra_ingest serves f32 as the torch module does
    (rtol 5e-4, atol 2e-5) and int8 within the drift gates; both packages
    ingest it to the same tree."""
    from anuraxla.models.hydra_ingest import ingest_foreign_checkpoint as j_ingest
    from anuraxla_torch.models.hydra_ingest import ingest_foreign_checkpoint

    from test_quant import _AVGPOOL_DIMS, _TorchAvgPoolEnc

    torch.manual_seed(3)
    mod = _TorchAvgPoolEnc().eval()
    pt = tmp_path / "avgpool.pt"
    torch.save(mod, pt)
    cfg, sd, _ = ingest_foreign_checkpoint(pt, n_mels=_AVGPOOL_DIMS["m"])
    jcfg, params, _ = j_ingest(pt, n_mels=_AVGPOOL_DIMS["m"])
    assert cfg.downsample == "avgpool" and cfg.input_hw == tuple(jcfg.input_hw)
    x = torch.from_numpy(_mel(cfg, 6, 11))
    enc = ConvVAEEncoder(cfg)
    enc.load_state_dict(sd)
    mu_f = enc(x)["mu"].detach().numpy()
    with torch.no_grad():
        ref = mod(x.permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(mu_f, ref, rtol=5e-4, atol=2e-5)
    q = tq.quantize_encoder(sd, cfg, x, device="cpu")
    _assert_tree(jq.quantize_encoder(params, jcfg, jnp.asarray(x.numpy())), q, act_rtol=1e-5)
    assert q["conv"]["EncoderBlock_0/Conv_0"]["wq"].dtype == torch.int8
    mu_q = tq.encoder_apply_quantized(q, cfg, x)["mu"].numpy()
    assert _cos(mu_f, mu_q).min() > 0.97
    assert (np.linalg.norm(mu_q - mu_f, axis=-1) / np.linalg.norm(mu_f, axis=-1)).max() < 0.25


@pytest.mark.parametrize("shape", [
    (1, 9, 7, 1, 5, 2, ((0, 1), (0, 1))),
    (3, 8, 6, 16, 24, 1, ((1, 1), (1, 1))),
    (2, 7, 5, 4, 12, 2, ((1, 1), (1, 1))),
    (5, 12, 4, 32, 8, 2, ((0, 1), (1, 1))),
], ids=["k9_b1", "cin16", "odd", "asym"])
def test_int8_conv_plain_is_exact(shape):
    """The plain version against a float64 conv of the same int8 operands,
    and its epilogue one rounding at a time; a CPU tensor launches nothing."""
    B, H, W, cin, cout, stride, pads = shape
    g = torch.Generator().manual_seed(sum(shape[:5]))
    x = torch.randint(-127, 128, (B, H, W, cin), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, dtype=torch.int8)
    sx, sw, bias = torch.rand(B, generator=g), torch.rand(cout, generator=g) * 0.01, torch.randn(cout, generator=g)
    (pt, pb), (pl, pr) = pads
    ref = torch.nn.functional.conv2d(torch.nn.functional.pad(x.permute(0, 3, 1, 2).double(), (pl, pr, pt, pb)),
                                     w.permute(3, 2, 0, 1).double(), stride=stride).permute(0, 2, 3, 1)
    n0 = ti8.launches()
    raw = ti8.int8_conv(x, w, sx, sw, bias, stride, pads, raw=True)
    assert raw.dtype == torch.int32 and torch.equal(raw.double(), ref)
    out = ti8.int8_conv(x, w, sx, sw, bias, stride, pads)
    want = raw.float() * (sx[:, None, None, None] * sw) + bias
    assert torch.equal(out, want)
    assert ti8.launches() == n0


def test_int8_dense_plain_is_exact():
    g = torch.Generator().manual_seed(1)
    for M, K, N in ((1, 12288, 512), (3, 9, 5)):
        x = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
        sx, sw, bias = torch.rand(M, 1, generator=g), torch.rand(N, generator=g), torch.randn(N, generator=g)
        raw = ti8.int8_dense(x, w, sx, sw, bias, raw=True)
        assert torch.equal(raw.double(), x.double() @ w.double())
        assert torch.equal(ti8.int8_dense(x, w, sx, sw, bias), raw.float() * (sx * sw) + bias)
        one = torch.tensor(0.5)  # a calibrated scale: one value for every row
        assert torch.equal(ti8.int8_dense(x, w, one, sw, bias), raw.float() * (one * sw) + bias)


# ---------------------------------------------------------------------------
# the session and the CLI
# ---------------------------------------------------------------------------

def _sessions(tmp_path):
    from anuraxla.constants import MelConfig as JMel
    from anuraxla.models.checkpoint import save_encoder as j_save
    from anuraxla.pipeline.session import EncoderSession as JSession
    from anuraxla_torch.constants import MelConfig
    from anuraxla_torch.pipeline.session import EncoderSession

    mel = dict(sr=16000, duration=0.5, target_frames=32, n_mels=32, fmax=7000)
    jcfg = JCfg(latent_dim=8, widths=(8, 16), dense_width=16, groups=4, input_hw=(32, 32))
    _, params = init_encoder(jcfg, 0)
    enc_dir = tmp_path / "enc"
    j_save(enc_dir, jcfg, params)

    def port(**kw):
        return EncoderSession(mel=MelConfig(**mel), encoder_dir=enc_dir, project_root=tmp_path, batch_size=4,
                              backend="matmul", device="cpu", **kw).load()

    def ref(**kw):
        return JSession(mel=JMel(**mel), encoder_dir=enc_dir, project_root=tmp_path, batch_size=4, **kw).load()

    return port, ref, MelConfig(**mel)


def test_quantized_session_matches_jax(tmp_path):
    """quantize=True on the port's session: the _q8 key (named for the plain
    version off the card), latents close to the f32 session's (the
    reference's 0.95 gate) and within the free-running bound of the
    reference's quantized session, which jits its forward."""
    from anuraxla.pipeline.session import session_fingerprint as j_fp
    from anuraxla_torch.pipeline.session import session_fingerprint

    port, ref, mel = _sessions(tmp_path)
    batch = (0.2 * np.random.default_rng(12).standard_normal((4, mel.num_samples))).astype(np.float32)
    s_f32, s_q8 = port(), port(quantize=True)
    z_f32, z_q8 = s_f32.encode_array(batch), s_q8.encode_array(batch)
    assert z_q8.shape == z_f32.shape and _cos(z_f32, z_q8).min() > 0.95
    fp, fp_q8 = session_fingerprint(s_f32), session_fingerprint(s_q8)
    assert fp != fp_q8 and fp_q8.endswith("_q8-cpuplain") and fp_q8.startswith(fp)
    j_q8 = ref(quantize=True)
    assert j_fp(j_q8).endswith("_q8")
    z_ref = j_q8.encode_array(batch)
    assert _row_rel(z_ref, z_q8).max() <= FREE_REL and _cos(z_ref, z_q8).min() >= FREE_COS


def test_bf16_with_quantize_refused_as_reference(tmp_path):
    port, ref, _ = _sessions(tmp_path)
    with pytest.raises(ValueError) as ej:
        ref(quantize=True, encoder_dtype="bfloat16")
    with pytest.raises(ValueError) as et:
        port(quantize=True, encoder_dtype="bfloat16")
    assert str(et.value) == str(ej.value)


def test_quantize_serving_in_the_cli(tmp_path, monkeypatch, capsys):
    """--quantize-serving: parsed like the reference's, carried into the
    session, forwarded by run-qout-grid; evaluate-wav serves it in the parity
    tier on the CPU and refuses it beside the balanced tier's bf16 trunk."""
    import json

    from anuraxla.cli import common as j_common
    from anuraxla_torch.cli import common as t_common
    from anuraxla_torch.cli import evaluate_wav as t_eval
    from anuraxla_torch.cli import run_qout_grid as t_grid
    from anuraxla_torch.cli import train_vae as t_train
    from anuraxla_torch.constants import DEFAULT_MEL, PRIORITY_ORDER
    from anuraxla_torch.pipeline.session import EncoderSession
    from anuraxla_torch.utils.wavio import read_wav, write_wav

    pt, pj = argparse.ArgumentParser(), argparse.ArgumentParser()
    t_common.add_batch_args(pt)
    j_common.add_batch_args(pj)
    for argv in ([], ["--quantize-serving"], ["--serving-tier", "parity", "--quantize-serving"]):
        st, sj = t_common.session_kwargs(pt.parse_args(argv)), j_common.session_kwargs(pj.parse_args(argv))
        assert st["quantize"] == sj["quantize"] == ("--quantize-serving" in argv)
    assert "TPU" not in pt.format_help() and "v5e" not in pt.format_help()
    shared = t_grid.subprocess_shared_args(t_grid.build_parser().parse_args(["--quantize-serving"]), "c.json")
    assert "--quantize-serving" in shared
    assert t_train.build_parser().parse_args(["--root", "r", "--quantize-serving"]).quantize_serving

    cfg = DEFAULT_MEL.replace(duration=1.0)
    rng = np.random.default_rng(13)
    paths = []
    for i, f in enumerate((700.0, 2900.0)):
        t = np.arange(cfg.num_samples) / cfg.sr
        paths.append(tmp_path / f"c{i}.wav")
        write_wav(paths[-1], (0.3 * np.sin(2 * np.pi * f * t) + 0.02 * rng.standard_normal(t.size))
                  .astype(np.float32), cfg.sr)
    sess = EncoderSession(mel=cfg, device="cpu", batch_size=1, init_seed=7, quantize=True).load()
    Z = sess.encode_array(np.stack([read_wav(p)[0] for p in paths]))
    sp = PRIORITY_ORDER[0]
    (tmp_path / "config.json").write_text(json.dumps({
        "species": [sp], "chunk_seconds": 1.0,
        "radial_detector": {"centroids": {sp: Z[0].tolist()},
                            "thresholds": {sp: 0.5 * float(np.linalg.norm(Z[1] - Z[0]))}}}))
    base = ["--config", str(tmp_path / "config.json"), "--device", "cpu", "--init-seed", "7"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        t_eval.main(["--wav", str(paths[0]), *base, "--serving-tier", "balanced", "--quantize-serving"])
    for p, code in ((paths[0], 0), (paths[1], 2)):
        with pytest.raises(SystemExit) as e:
            t_eval.main(["--wav", str(p), *base, "--serving-tier", "parity", "--quantize-serving"])
        assert e.value.code == code
    capsys.readouterr()


# ---------------------------------------------------------------------------
# measuring the free-running bound: PYTHONPATH=. python tests/test_torch_quant.py [--seeds N]
# ---------------------------------------------------------------------------

def _measure(seeds: int) -> None:
    """Free running, port vs the reference's eager forward (and the
    reference's jit against its own eager forward), over ``seeds`` batches
    of 4 rows of N(0, 1) mels for the default VAEConfig and 8 rows for each
    small family."""
    for family, is_full, b in (("stride", True, 4), ("stride", False, 8), ("avgpool", False, 8)):
        jcfg, tcfg = _cfgs(family, full=is_full)
        params, sd = _params(jcfg, tcfg, 0)
        qj, qt = jq.quantize_encoder(params, jcfg), tq.quantize_encoder(sd, tcfg, device="cpu")
        jit = jax.jit(jq.encoder_apply_quantized, static_argnums=1)
        rel, cos, rel_jit = [], [], []
        for s in range(seeds):
            x = _mel(jcfg, b, 1000 + s)
            ref = np.asarray(jq.encoder_apply_quantized(qj, jcfg, jnp.asarray(x))["mu"])
            got = tq.encoder_apply_quantized(qt, tcfg, torch.from_numpy(x))["mu"].numpy()
            rel += list(_row_rel(ref, got))
            cos += list(_cos(ref, got))
            rel_jit += list(_row_rel(ref, np.asarray(jit(qj, jcfg, jnp.asarray(x))["mu"])))
        rel, cos, rel_jit = map(np.asarray, (rel, cos, rel_jit))
        print(f"{family} {'default VAEConfig' if is_full else 'small'}: {rel.size} rows; port vs reference: "
              f"row rel max {rel.max():.4g}, median {np.median(rel):.3g}, {np.mean(rel <= 1e-3):.3f} within 1e-3; "
              f"cosine min {cos.min():.6f}; reference jit vs eager: row rel max {rel_jit.max():.4g}, "
              f"{np.mean(rel_jit <= 1e-3):.3f} within 1e-3")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=_measure.__doc__)
    ap.add_argument("--seeds", type=int, default=24)
    _measure(ap.parse_args().seeds)
