"""The port's serving tiers held against the JAX package on the CPU: the bf16
mel mode (tables bitwise, plain version against the Pallas kernel in interpret
mode), the fast frontend on every backend, the fast-tier session with
carried-over weights, the tier knobs of the CLI, ``reconfigure`` and the cache
fingerprints. Inputs come from numpy seeds and go to both packages.

Tolerances: exact paths 1e-4 on log-mels (test_pallas_frontend.py:153);
bf16 paths 1e-2 of the mel power's max (:169). Where the port rounds to bf16
and JAX on a CPU does not (``Precision.DEFAULT`` is f32 there), log-mels are
held to 5e-2 (measured <= 3.4e-2; the bf16 tier's documented error is ~6e-2
in standardized dB)."""

import argparse
import itertools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from anuraxla.cli import common as j_common
from anuraxla.constants import DEFAULT_MEL as J_DEFAULT_MEL
from anuraxla.constants import MelConfig as JMel
from anuraxla.ops import frontend as jfe
from anuraxla.ops import pallas_frontend as jpf
from anuraxla.ops import stft as jstft
from anuraxla.pipeline import session as j_session
from anuraxla_torch.cli import common as t_common
from anuraxla_torch.cli import evaluate_wav as t_cli
from anuraxla_torch.constants import DEFAULT_MEL, PRIORITY_ORDER, MelConfig
from anuraxla_torch.models.convert import encoder_state_from_jax
from anuraxla_torch.models.vae import VAEConfig
from anuraxla_torch.ops import frontend as tfe
from anuraxla_torch.ops import mel_kernel as tk
from anuraxla_torch.ops import stft as tstft
from anuraxla_torch.pipeline import session as t_session
from anuraxla_torch.pipeline.session import EncoderSession
from anuraxla_torch.utils.wavio import read_wav, write_wav

SMALL = dict(sr=16000, duration=0.5, n_mels=32, fmin=100.0, fmax=7500.0,
             hop_length=128, n_fft=256, target_frames=48)
R16 = dict(sr=48000, duration=1.0, n_mels=64, fmin=150.0, fmax=15000.0,
           hop_length=384, n_fft=2048, target_frames=64)
# the fast frontend crops: clips longer than target_frames frames
FAST = {
    "small": dict(SMALL, duration=1.5),
    "r16": dict(R16, duration=1.0, target_frames=32),
    "hop160": dict(SMALL, duration=1.0, hop_length=160, n_fft=512, target_frames=32),
    "hop80": dict(SMALL, duration=1.0, hop_length=80, n_fft=400, target_frames=32),
    "hop441": dict(SMALL, duration=1.0, hop_length=441, n_fft=512, target_frames=16),
}
# the port's backend -> the JAX package's
J_BACKEND = {"cuda": "pallas", "cuda-bf16": "pallas-bf16", "matmul": "matmul", "matmul-bf16": "matmul-bf16"}


def _rows(cfg, B, seed):
    """[B, num_samples] rows: row 0 silent, row 1 clips after RMS scaling."""
    rng = np.random.default_rng(seed)
    y = (0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)
    y[0] = 1e-7 * rng.standard_normal(cfg.num_samples)
    y[1] = 0.001 * rng.standard_normal(cfg.num_samples)
    y[1, :: cfg.num_samples // 5] = 0.9
    return y


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint16)


@pytest.mark.parametrize("n_fft", [256, 384, 2048])
def test_bf16_tables_bitwise(n_fft):
    """The bf16 mode's tables are the ``hi`` halves of the reference's."""
    args = (48000, n_fft, 64, 150.0, 15000.0)
    (chi, _), (shi, _), fbpair, _ = jpf._ct_tables_folded(*args)
    C, S, FBM = tk.ct_tables_bf16(*args)
    for got, want in ((C, chi), (S, shi), (FBM, fbpair[:, :64])):
        assert got.dtype == torch.bfloat16 and want.dtype == ml_dtypes.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), _bits(np.asarray(want)))
    # the f32 tensors the kernel and its plain version multiply by hold exactly these values
    dev = tk._tables(MelConfig(n_fft=n_fft), torch.device("cpu"), "ct", False)
    for got, want in zip(dev[:3], (C, S, FBM)):
        assert got.dtype == torch.float32 and torch.equal(got, want.float())


@pytest.mark.parametrize("name,pre_padded", [("small", True), ("small", False), ("r16", True)])
def test_bf16_plain_vs_pallas(name, pre_padded):
    """exact=False: the plain version against the Pallas kernel in interpret
    mode (which really casts to bf16). Both round the same values; they
    differ by f32 summation order and the bf16 roundings that order flips.
    Measured here: <= 4.0e-4 of each row's max, held at 2e-3; against the
    exact math the mode is held at the bf16 tier's 1e-2 (measured 4.7e-3)."""
    cfg = dict(SMALL if name == "small" else R16)
    tc, jc = MelConfig(**cfg), JMel(**cfg)
    y = _rows(tc, 3, seed=21)
    s = np.array(jfe.rms_scale_batch(jnp.asarray(y)))
    assert s[0] == -1.0 and np.abs(y[1] * s[1]).max() > 1.0
    T = tc.total_frames
    x = y
    if pre_padded:
        L_pad, off = tk.phase_padded_layout(tc, T)
        x = np.zeros((3, L_pad), np.float32)
        x[:, off : off + tc.num_samples] = y
    ref = np.asarray(jpf.mel_power_pallas(jnp.asarray(x), jc, num_frames=T, interpret=True, exact=False,
                                          rms_scale=jnp.asarray(s), pre_padded=pre_padded))
    got = tk.mel_power(torch.from_numpy(x), tc, num_frames=T, exact=False,
                       rms_scale=torch.from_numpy(s), pre_padded=pre_padded).numpy()
    exact = tk.mel_power(torch.from_numpy(x), tc, num_frames=T, rms_scale=torch.from_numpy(s),
                         pre_padded=pre_padded).numpy()
    m = ref.max(axis=(1, 2), keepdims=True)
    assert got.shape == ref.shape == (3, T, tc.n_mels)
    np.testing.assert_allclose(got / m, ref / m, atol=2e-3)
    np.testing.assert_allclose(got / m, exact / m, atol=1e-2)
    assert np.abs(got - exact).max() > 0  # the mode really rounds


def test_stft_power_first_frame_and_bf16():
    cfg = MelConfig(**FAST["small"])
    y = _rows(cfg, 2, seed=22)
    kw = dict(n_fft=cfg.n_fft, hop_length=cfg.hop_length, num_frames=cfg.target_frames, first_frame=23)
    ref = np.asarray(jstft.stft_power(jnp.asarray(y), **kw))
    got = tstft.stft_power(torch.from_numpy(y), **kw).numpy()
    np.testing.assert_allclose(got / ref.max(), ref / ref.max(), atol=2e-6)
    fr = tstft.frame_signal(torch.from_numpy(y), **kw).numpy()
    assert np.array_equal(fr, np.asarray(jstft.frame_signal(jnp.asarray(y), **kw)))
    # bf16: against the reference's DEFAULT precision (f32 on a CPU) at the
    # bf16 tolerance, and exactly what rounding both operands in numpy gives
    ref16 = np.asarray(jstft.stft_power(jnp.asarray(y), **kw, precision=jax.lax.Precision.DEFAULT))
    got16 = tstft.stft_power(torch.from_numpy(y), **kw, bf16=True).numpy()
    np.testing.assert_allclose(got16 / ref16.max(), ref16 / ref16.max(), atol=1e-2)
    rnd = lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float64)  # noqa: E731
    cos_b, sin_b = (rnd(b) for b in tstft._dft_bases(cfg.n_fft))
    want = (rnd(fr) @ cos_b) ** 2 + (rnd(fr) @ sin_b) ** 2
    np.testing.assert_allclose(got16 / want.max(), want / want.max(), atol=2e-6)


def _jax_log_mel(y, jc, *, parity, backend, rms_scale=None, pre_padded=False):
    """The reference's ``log_mel_batch`` with its Pallas backends really
    reaching the kernels on a CPU: the kernel runs in interpret mode (as
    test_pallas_frontend.py patches it) and the no-TPU fallback of
    ``resolved_backend`` is bypassed, through the un-jitted function so that
    no cached trace of the fallback is reused."""
    orig_kernel, orig_gate = jpf.mel_power_pallas, jfe.resolved_backend
    try:
        jpf.mel_power_pallas = lambda *a, **k: orig_kernel(*a, **{**k, "interpret": True})
        if jpf.pallas_supported(jc):
            jfe.resolved_backend = lambda cfg, b: b
        return np.asarray(jfe.log_mel_batch.__wrapped__(
            jnp.asarray(y), jc, parity=parity, backend=backend,
            rms_scale=None if rms_scale is None else jnp.asarray(rms_scale), pre_padded=pre_padded))
    finally:
        jpf.mel_power_pallas, jfe.resolved_backend = orig_kernel, orig_gate


@pytest.mark.parametrize("backend", tfe.BACKENDS)
@pytest.mark.parametrize("name", ["small", "r16", "hop160", "hop80", "hop441"])
def test_fast_frontend_log_mel_vs_jax(name, backend):
    """``log_mel_batch(parity=False)``: the crop-first frame range and the
    statistics over the cropped plane, on every backend and hop family
    (ct at hop % 128 and % 32, dense, and hop 441 that no kernel takes)."""
    tc, jc = MelConfig(**FAST[name]), JMel(**FAST[name])
    assert tc.total_frames > tc.target_frames
    y = _rows(tc, 3, seed=23)
    s = np.array(jfe.rms_scale_batch(jnp.asarray(y)))
    ref = _jax_log_mel(y, jc, parity=False, backend=J_BACKEND[backend], rms_scale=s)
    got = tfe.log_mel_batch(torch.from_numpy(y), tc, parity=False, backend=backend,
                            rms_scale=torch.from_numpy(s)).numpy()
    assert got.shape == ref.shape == (3, tc.target_frames, tc.n_mels)
    if not backend.endswith("bf16"):
        atol = 1e-4
    elif tfe.resolved_backend(tc, backend) == "cuda-bf16" and tk.resolve_algorithm(tc) == "ct":
        atol = 1e-2  # both sides round to bf16 at the same points (measured <= 4.5e-3)
    else:
        atol = 5e-2  # the reference's DEFAULT precision is f32 on a CPU: only the port rounds
    np.testing.assert_allclose(got, ref, atol=atol)
    # the fast frontend is not the parity frontend cropped: its statistics differ
    par = tfe.log_mel_batch(torch.from_numpy(y), tc, parity=True, backend=backend,
                            rms_scale=torch.from_numpy(s)).numpy()
    assert np.abs(par - got).max() > 1e-3


def test_fast_frontend_long_clip():
    """A 6 s clip: the cropped frame range ends before the signal does
    (test_pallas_frontend.py's 'ct tiling underflow' case)."""
    cfg = dict(R16, duration=6.0, target_frames=192)
    tc, jc = MelConfig(**cfg), JMel(**cfg)
    first = (tc.total_frames - tc.target_frames) // 2
    assert (first + tc.target_frames) * tc.hop_length + tc.n_fft // 2 < tc.num_samples + tc.n_fft
    y = _rows(tc, 2, seed=24)[1:]
    ref = _jax_log_mel(y, jc, parity=False, backend="pallas")
    for backend in ("cuda", "matmul"):
        got = tfe.log_mel_batch(torch.from_numpy(y), tc, parity=False, backend=backend).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4)


def test_fast_frontend_pre_padded():
    """Pre-padded rows in fast-frontend mode go to the kernel (the layout for
    the cropped range); the matmul backends refuse them, as the reference."""
    tc, jc = MelConfig(**FAST["small"]), JMel(**FAST["small"])
    first = (tc.total_frames - tc.target_frames) // 2
    y = _rows(tc, 2, seed=25)
    L_pad, off = tk.phase_padded_layout(tc, first + tc.target_frames)
    assert jpf.phase_padded_layout(jc, first + tc.target_frames) == (L_pad, off)
    keep = min(tc.num_samples, L_pad - off)
    yp = np.zeros((2, L_pad), np.float32)
    yp[:, off : off + keep] = y[:, :keep]
    ref = _jax_log_mel(yp, jc, parity=False, backend="pallas", pre_padded=True)
    got = tfe.log_mel_batch(torch.from_numpy(yp), tc, parity=False, backend="cuda", pre_padded=True).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    unpadded = tfe.log_mel_batch(torch.from_numpy(y), tc, parity=False, backend="cuda").numpy()
    np.testing.assert_allclose(got, unpadded, atol=1e-5)
    for backend in ("matmul", "matmul-bf16"):
        with pytest.raises(ValueError, match="pre_padded"):
            tfe.log_mel_batch(torch.from_numpy(yp), tc, parity=False, backend=backend, pre_padded=True)
        with pytest.raises(ValueError, match="pre_padded"):
            jfe.log_mel_batch.__wrapped__(jnp.asarray(yp), jc, parity=False, backend=backend, pre_padded=True)


def _write_wavs(d, cfg, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.num_samples) / cfg.sr
    paths = []
    for i in range(n):
        y = 0.3 * np.sin(2 * np.pi * (700 + 900 * i) * t) * (rng.random(t.size) > 0.3)
        y = y + 0.02 * rng.standard_normal(t.size)
        p = d / f"c{i}.wav"
        write_wav(p, y.astype(np.float32), cfg.sr)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def jax_session(tmp_path_factory):
    """One loaded JAX session (seeded init) and its weights carried over."""
    root = tmp_path_factory.mktemp("jax_session")
    js = j_session.EncoderSession(mel=J_DEFAULT_MEL, backend="matmul", normalize_on_device=True,
                                  project_root=root, batch_size=2).load()
    params = encoder_state_from_jax(jax.tree_util.tree_map(np.asarray, js._params), VAEConfig())
    return js, params, root


def test_fast_tier_session_vs_jax(jax_session, tmp_path):
    """The fast tier end to end at full width: the exact fast frontend
    (matmul) to the f32 tier's tolerance; the bf16 kernel backend against the
    reference's ``pallas-bf16`` session, which on a CPU resolves to f32
    matmul math — cosine >= 0.999 and the documented latent drift (6.5e-2);
    the bf16 trunk on top stays within cosine 0.99."""
    js, params, root = jax_session
    paths = _write_wavs(tmp_path, DEFAULT_MEL, 2, seed=26)
    kw = dict(mel=DEFAULT_MEL, device="cpu", normalize_on_device=True, batch_size=2, parity=False)
    jkw = dict(mel=J_DEFAULT_MEL, normalize_on_device=True, project_root=root, batch_size=2, parity=False)
    Zj, okj, _ = j_session.EncoderSession(**jkw, backend="matmul").load().encode_paths(paths)
    Zt, okt, _ = EncoderSession(**kw, backend="matmul").load(params).encode_paths(paths)
    assert okj.all() and okt.all() and Zt.shape == (2, 128)
    np.testing.assert_allclose(Zt, Zj, rtol=5e-4, atol=2e-5)

    Zj16, _, _ = j_session.EncoderSession(**jkw, backend="pallas-bf16").load().encode_paths(paths)
    fast = EncoderSession(**kw, backend="cuda-bf16").load(params)
    Zt16, _, _ = fast.encode_paths(paths)
    cos = (Zt16 * Zj16).sum(1) / (np.linalg.norm(Zt16, axis=1) * np.linalg.norm(Zj16, axis=1))
    assert cos.min() >= 0.999
    np.testing.assert_allclose(Zt16, Zj16, atol=6.5e-2)
    assert np.abs(Zt16 - Zt).max() > 1e-5  # the bf16 mode really ran
    Zb, _, _ = EncoderSession(**kw, backend="cuda-bf16", encoder_dtype="bfloat16").load(params).encode_paths(paths)
    cosb = (Zb * Zt16).sum(1) / (np.linalg.norm(Zb, axis=1) * np.linalg.norm(Zt16, axis=1))
    assert cosb.min() > 0.99
    # the fast tier cannot decode into the pre-padded layout
    with pytest.raises(ValueError, match="pre_padded_host"):
        EncoderSession(**kw, backend="cuda-bf16", pre_padded_host=True).load(params)
    with pytest.raises(ValueError, match="backend"):
        EncoderSession(mel=DEFAULT_MEL, device="cpu", backend="pallas").load(params)


def test_reconfigure_matches_reference_surface():
    """``reconfigure`` takes duration, parity and backend; it derives the
    layout and validates again, and resets the fingerprint."""
    cfg = DEFAULT_MEL.replace(duration=1.0)
    s = EncoderSession(mel=cfg, device="cpu", pre_padded_host=True, init_seed=1).load()
    fp0 = t_session.session_fingerprint(s)
    assert s._layout == tk.phase_padded_layout(cfg, cfg.total_frames)
    assert s.reconfigure(duration=1.0, parity=True, backend="cuda") is s and s._fingerprint == fp0
    s.reconfigure(duration=2.0)
    assert s._layout == tk.phase_padded_layout(cfg.replace(duration=2.0), s.mel.total_frames)
    assert t_session.session_fingerprint(s) != fp0
    for bad in (dict(parity=False), dict(backend="matmul"), dict(backend="cuda-bf16")):
        t = EncoderSession(mel=cfg, device="cpu", pre_padded_host=True, init_seed=1).load()
        with pytest.raises(ValueError, match="pre_padded_host"):
            t.reconfigure(**bad)
    u = EncoderSession(mel=cfg, device="cpu", init_seed=1).load()
    audio = _rows(cfg, 2, seed=27)
    Zp = u.encode_array(audio)
    Zf = u.reconfigure(parity=False, backend="cuda-bf16").encode_array(audio)
    assert (u.parity, u.backend) == (False, "cuda-bf16") and np.abs(Zp - Zf).max() > 1e-4
    fresh = EncoderSession(mel=cfg, device="cpu", init_seed=1, parity=False, backend="cuda-bf16").load()
    assert np.array_equal(fresh.encode_array(audio), Zf)
    with pytest.raises(ValueError, match="backend"):
        u.reconfigure(backend="pallas")


TIERS = ["custom", "parity", "balanced", "fast"]


def _parsers():
    pt, pj = argparse.ArgumentParser(), argparse.ArgumentParser()
    t_common.add_batch_args(pt)
    j_common.add_batch_args(pj)
    return pt, pj


@pytest.mark.parametrize("backend", [None, "cuda", "cuda-bf16", "matmul"])
@pytest.mark.parametrize("tier", TIERS)
def test_resolve_tier_knobs_vs_reference(tier, backend):
    """Every tier x typed-flag case through both packages' parsers: a typed
    flag beats the tier, an absent one takes the tier's value. The port's
    backends carry their own names, and with no tier and no flag the port
    serves its kernel backend where the reference's CLI defaults to matmul."""
    pt, pj = _parsers()
    for fast, dtype in itertools.product([False, True], [None, "float32", "bfloat16"]):
        argv_t, argv_j = ["--serving-tier", tier], ["--serving-tier", tier]
        if backend is not None:
            argv_t += ["--frontend-backend", backend]
            argv_j += ["--frontend-backend", J_BACKEND[backend]]
        for argv in (argv_t, argv_j):
            argv += ["--fast-frontend"] * fast + (["--encoder-dtype", dtype] if dtype else [])
        at, aj = pt.parse_args(argv_t), pj.parse_args(argv_j)
        kt, kj = t_common.resolve_tier_knobs(at), j_common.resolve_tier_knobs(aj)
        want = dict(kj, frontend_backend={v: k for k, v in J_BACKEND.items()}[kj["frontend_backend"]])
        if tier == "custom" and backend is None:
            assert kj["frontend_backend"] == "matmul"
            want["frontend_backend"] = "cuda"
        assert kt == want
        st, sj = t_common.session_kwargs(at), j_common.session_kwargs(aj)
        assert set(sj) - set(st) == {"data_parallel", "quantize"}  # later slices of the port
        for k in ("batch_size", "num_threads", "parity", "transfer_int16", "encoder_dtype", "pre_padded_host"):
            assert st[k] == sj[k]
        assert st["backend"] == want["frontend_backend"]
        EncoderSession(mel=DEFAULT_MEL, device="cpu", **st)  # every key is a session field


def test_tier_table_and_mel_from_args():
    assert set(t_common.SERVING_TIERS) == set(j_common.SERVING_TIERS)
    for tier, knobs in j_common.SERVING_TIERS.items():
        assert t_common.SERVING_TIERS[tier] == dict(
            knobs, frontend_backend={"pallas": "cuda", "pallas-bf16": "cuda-bf16"}[knobs["frontend_backend"]])
    pt, pj = argparse.ArgumentParser(), argparse.ArgumentParser()
    t_common.add_mel_args(pt)
    j_common.add_mel_args(pj)
    argv = ["--hop-length", "320", "--n-mels", "48", "--fmax", "12000"]
    mt, mj = t_common.mel_from_args(pt.parse_args(argv), 3.0), j_common.mel_from_args(pj.parse_args(argv), 3.0)
    assert mt == MelConfig(hop_length=320, n_mels=48, fmax=12000.0, duration=3.0)
    assert t_session.mel_fingerprint(mt) == j_session.mel_fingerprint(mj)


def _fp(params, **kw):
    s = EncoderSession(**{"mel": DEFAULT_MEL, "device": "cpu", **kw}).load(params)
    return t_session.session_fingerprint(s)


def test_fingerprint_never_equals_the_jax_package(jax_session):
    """No cache key of the port equals the JAX package's for the same
    settings, on any backend — the matmul names are shared, the framework tag
    is not."""
    js, params, root = jax_session
    for parity, (tb, jb) in itertools.product([True, False], J_BACKEND.items()):
        j = j_session.EncoderSession(mel=J_DEFAULT_MEL, backend=jb, parity=parity, project_root=root)
        j._params, j._enc_cfg = js._params, js._enc_cfg
        fj = j_session.session_fingerprint(j)
        ft = _fp(params, backend=tb, parity=parity)
        assert ft != fj
        assert f"_p{int(parity)}_torch-{tb}_e" in ft
        if tb.startswith("matmul"):
            # mel, mode and backend name coincide: without the tag only the digest would differ
            assert ft.split("_e")[0].replace("torch-", "") == fj.split("_e")[0]


def test_fingerprint_splits(jax_session):
    _, params, _ = jax_session
    base = _fp(params)
    assert base == _fp(params) and base.startswith(t_session.mel_fingerprint(DEFAULT_MEL) + "_p1_torch-cuda_e")
    variants = [
        dict(backend="cuda-bf16"), dict(backend="matmul"), dict(backend="matmul-bf16"), dict(parity=False),
        dict(encoder_dtype="bfloat16"), dict(transfer_int16=True), dict(normalize_on_device=True),
        dict(add_noise_db=6.0), dict(add_noise_db=6.0, noise_seed=3), dict(mel=DEFAULT_MEL.replace(hop_length=320)),
        dict(encoder_cfg=VAEConfig(gn_eps=1e-5)),
    ]
    keys = [base] + [_fp(params, **v) for v in variants]
    assert len(set(keys)) == len(keys)
    assert _fp(params, transfer_int16=True).endswith("_i16")
    assert _fp(params, normalize_on_device=True, add_noise_db=6.0, noise_seed=3).endswith("_ndev_nz6s3")
    # the EFFECTIVE backend is keyed: a kernel backend on a config no kernel takes runs matmul math
    odd = DEFAULT_MEL.replace(hop_length=441)
    assert _fp(params, mel=odd, backend="cuda") == _fp(params, mel=odd, backend="matmul")
    assert _fp(params, mel=odd, backend="cuda-bf16") == _fp(params, mel=odd, backend="matmul-bf16")
    # layout and batching do not change latents: no split
    assert _fp(params, pre_padded_host=True) == _fp(params, batch_size=7) == base
    # other weights, other key
    other = {k: v.clone() for k, v in params.items()}
    first = sorted(other)[0]
    other[first].view(-1)[0] += 1.0
    assert _fp(other) != base
    assert str(t_session.cache_path_for("c", "/data/chunks_x", "Pleurodema_thaul", "_aug")) == str(
        j_session.cache_path_for("c", "/data/chunks_x", "Pleurodema_thaul", "_aug"))


def test_cli_serving_tiers(tmp_path, capsys):
    """``evaluate_wav --serving-tier``: every tier gives the parity tier's
    decision and exit code on the CPU (the fast tier through the plain bf16
    version), and a typed flag beats the tier."""
    cfg = DEFAULT_MEL.replace(duration=1.0)
    paths = _write_wavs(tmp_path, cfg, 2, seed=28)
    sess = EncoderSession(mel=cfg, device="cpu", batch_size=1, init_seed=7).load()
    Z = sess.encode_array(np.stack([read_wav(p)[0] for p in paths]))
    sp = PRIORITY_ORDER[0]
    radius = 0.5 * float(np.linalg.norm(Z[1] - Z[0]))
    (tmp_path / "config.json").write_text(json.dumps({
        "species": [sp], "chunk_seconds": 1.0,
        "radial_detector": {"centroids": {sp: Z[0].tolist()}, "thresholds": {sp: radius}}}))
    base = ["--config", str(tmp_path / "config.json"), "--device", "cpu", "--init-seed", "7"]
    for tier_args in (["--serving-tier", "parity"], ["--serving-tier", "balanced"], ["--serving-tier", "fast"],
                      ["--serving-tier", "fast", "--encoder-dtype", "float32"],
                      ["--fast-frontend", "--frontend-backend", "matmul-bf16"]):
        for p, code, mark in ((paths[0], 0, "✅ DETECTED: " + sp), (paths[1], 2, "❌ NO DETECT")):
            with pytest.raises(SystemExit) as e:
                t_cli.main(["--wav", str(p), *base, *tier_args])
            assert e.value.code == code
            assert mark in capsys.readouterr().out
    args = t_cli.build_parser().parse_args(["--wav", "x.wav", "--serving-tier", "fast"])
    assert t_common.session_kwargs(args) == dict(
        batch_size=1, num_threads=16, parity=False, backend="cuda-bf16", transfer_int16=False,
        encoder_dtype="bfloat16", pre_padded_host=False)
