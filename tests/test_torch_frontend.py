"""The port's frontend (``anuraxla_torch.ops``) held against the JAX package
on the CPU: copied host tables bitwise, the mel kernel's plain version
against the Pallas kernel in interpret mode (2e-5 of max, the exact tier's
bound of test_pallas_frontend.py), the log-mel frontend against JAX's matmul
backend (1e-4). Inputs come from numpy seeds and go to both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anuraxla.constants import MelConfig as JMel
from anuraxla.ops import frontend as jfe
from anuraxla.ops import mel as jmel
from anuraxla.ops import pallas_frontend as jpf
from anuraxla.ops import stft as jstft
from anuraxla_torch.constants import MelConfig
from anuraxla_torch.ops import frontend as tfe
from anuraxla_torch.ops import mel as tmel
from anuraxla_torch.ops import mel_kernel as tk
from anuraxla_torch.ops import stft as tstft

SMALL = dict(sr=16000, duration=0.5, n_mels=32, fmin=100.0, fmax=7500.0,
             hop_length=128, n_fft=256, target_frames=48)
R16 = dict(sr=48000, duration=1.0, n_mels=64, fmin=150.0, fmax=15000.0,
           hop_length=384, n_fft=2048, target_frames=64)
CONFIGS = {"small": SMALL, "r16": R16}


def _rows(cfg, B, seed):
    """[B, num_samples] rows: row 0 silent, row 1 clips after RMS scaling."""
    rng = np.random.default_rng(seed)
    y = (0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)
    y[0] = 1e-7 * rng.standard_normal(cfg.num_samples)
    y[1] = 0.001 * rng.standard_normal(cfg.num_samples)
    y[1, :: cfg.num_samples // 5] = 0.9
    return y


def _padded(cfg, y):
    L_pad, off = tk.phase_padded_layout(cfg, cfg.total_frames)
    yp = np.zeros((y.shape[0], L_pad), np.float32)
    yp[:, off : off + cfg.num_samples] = y
    return yp


@pytest.mark.parametrize("n_fft,n_mels,sr", [(256, 32, 16000), (384, 32, 16000), (2048, 64, 48000)])
def test_copied_tables_bitwise(n_fft, n_mels, sr):
    args = (sr, n_fft, n_mels, 150.0, sr / 2 * 0.6)
    assert np.array_equal(tmel.mel_filterbank(*args), jmel.mel_filterbank(*args))
    assert np.array_equal(tstft.hann_window(n_fft), jstft.hann_window(n_fft))
    for a, b in zip(tstft._dft_bases(n_fft), jstft._dft_bases(n_fft)):
        assert np.array_equal(a, b)
    f = np.linspace(0, sr / 2, 37)
    assert np.array_equal(tmel.hz_to_mel(f), jmel.hz_to_mel(f))
    assert np.array_equal(tmel.mel_to_hz(f / 100), jmel.mel_to_hz(f / 100))


@pytest.mark.parametrize("hop,n_fft,duration", [(128, 256, 0.5), (384, 2048, 5.0), (128, 2048, 1.2), (512, 1024, 2.0)])
def test_phase_padded_layout_and_gate(hop, n_fft, duration):
    kw = dict(sr=48000, duration=duration, hop_length=hop, n_fft=n_fft)
    tc, jc = MelConfig(**kw), JMel(**kw)
    for T in (1, tc.total_frames, 129, 300):
        assert tk.phase_padded_layout(tc, T) == jpf.phase_padded_layout(jc, T)
    assert tk.phase_padded_layout(MelConfig(), 626) == (294912, 1024)
    for h in (96, 128, 160, 384, 441):
        for n in (200, 256, 384, 2048):
            c = dict(kw, hop_length=h, n_fft=n)
            for alg in ("auto", "ct", "dense"):
                assert tk.kernel_supported(MelConfig(**c), alg) == jpf.pallas_supported(JMel(**c), alg)


def _f64_folded(sr, n_fft, n_mels, fmin, fmax):
    """The float64 construction inside the reference's _ct_tables_folded,
    rebuilt from the reference's own mel_filterbank."""
    R = n_fft // 128
    n_freq, n_half = n_fft // 2 + 1, R // 2 + 1
    n2 = np.arange(128, dtype=np.float64)[:, None]
    q = np.arange(128, dtype=np.float64)[None, :]
    fb = jmel.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    C = np.zeros((n_half * 128, 128))
    S = np.zeros_like(C)
    FBM = np.zeros((n_half * 128, n_mels))
    for r in range(n_half):
        ang = 2.0 * np.pi * n2 * (q * R + r) / n_fft
        C[r * 128 : (r + 1) * 128] = np.cos(ang)
        S[r * 128 : (r + 1) * 128] = np.sin(ang)
        for qq in range(128):
            if qq * R + r < n_freq:
                FBM[r * 128 + qq] += fb[qq * R + r]
            kp = (127 - qq) * R + (R - r)
            if not (r == 0 or 2 * r == R) and kp < n_freq:
                FBM[r * 128 + qq] += fb[kp]
    return C, S, FBM


@pytest.mark.parametrize("n_fft", [256, 384, 2048])
def test_ct_tables_folded_f32(n_fft):
    args = (48000, n_fft, 64, 150.0, 15000.0)
    C, S, FBM, win = tk.ct_tables_folded(*args)
    for got, want in zip((C, S, FBM), _f64_folded(*args)):
        assert got.dtype == np.float32
        assert np.array_equal(got, want.astype(np.float32))
    assert np.array_equal(win, jstft.hann_window(n_fft))
    # the reference's bf16 hi/lo pairs carry the same tables to ~2^-16
    (chi, clo), (shi, slo), fbpair, _ = jpf._ct_tables_folded(*args)
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    np.testing.assert_allclose(f(chi) + f(clo), C, atol=2e-5)
    np.testing.assert_allclose(f(shi) + f(slo), S, atol=2e-5)
    fm = np.abs(FBM).max()
    np.testing.assert_allclose(f(fbpair[:, :64]) + f(fbpair[:, 64:]), FBM, atol=2e-5 * fm)


@pytest.mark.parametrize("name", ["small", "r16"])
@pytest.mark.parametrize("pre_padded", [True, False])
def test_mel_power_plain_vs_pallas(name, pre_padded):
    tc, jc = MelConfig(**CONFIGS[name]), JMel(**CONFIGS[name])
    y = _rows(tc, 3, seed=1)
    s = np.asarray(jfe.rms_scale_batch(jnp.asarray(y)))
    assert s[0] == -1.0 and s[1] > 0
    assert np.abs(y[1] * s[1]).max() > 1.0  # row 1 really clips
    T = tc.total_frames
    x = _padded(tc, y) if pre_padded else y
    ref = np.asarray(jpf.mel_power_pallas(
        jnp.asarray(x), jc, num_frames=T, interpret=True, assembly="phase",
        rms_scale=jnp.asarray(s), pre_padded=pre_padded,
    ))
    got = tk.mel_power(torch.from_numpy(x), tc, num_frames=T,
                       rms_scale=torch.from_numpy(s), pre_padded=pre_padded)
    assert not any(tk.mel_power.launches.values())  # the CPU path never counts a launch
    assert got.shape == ref.shape == (3, T, tc.n_mels)
    # each row against its own max, so the silent row (raw passthrough, power
    # ~1e-12 of the others') is held to the same bound
    m = ref.max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(got.numpy() / m, ref / m, atol=2e-5)


@pytest.mark.parametrize("name", ["small", "r16"])
@pytest.mark.parametrize("backend", ["cuda", "matmul"])
def test_log_mel_batch_vs_jax(name, backend):
    tc, jc = MelConfig(**CONFIGS[name]), JMel(**CONFIGS[name])
    y = _rows(tc, 3, seed=2)
    s_j = jfe.rms_scale_batch(jnp.asarray(y))
    ref = np.asarray(jfe.log_mel_batch(jnp.asarray(y), jc, backend="matmul", rms_scale=s_j))
    s_t = tfe.rms_scale_batch(torch.from_numpy(y))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)
    got = tfe.log_mel_batch(torch.from_numpy(_padded(tc, y)), tc, backend=backend,
                            rms_scale=s_t, pre_padded=True)
    assert got.shape == ref.shape == (3, tc.target_frames, tc.n_mels)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    # unpadded rows without fused scale (pre-normalized input)
    yn = np.asarray(jfe.rms_normalize_batch(jnp.asarray(y))[0])
    ref2 = np.asarray(jfe.log_mel_batch(jnp.asarray(yn), jc, backend="matmul"))
    got2 = tfe.log_mel_batch(torch.from_numpy(yn), tc, backend=backend)
    np.testing.assert_allclose(got2.numpy(), ref2, atol=1e-4)


def test_rms_helpers_vs_jax():
    y = _rows(MelConfig(**SMALL), 4, seed=3)
    yj, mj = jfe.rms_normalize_batch(jnp.asarray(y))
    yt, mt = tfe.rms_normalize_batch(torch.from_numpy(y))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6, atol=1e-7)
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    yn, mn = tfe.rms_normalize_np(y)
    yr, mr = jfe.rms_normalize_np(y)
    assert np.array_equal(yn, yr) and np.array_equal(mn, mr)
    s = tfe.rms_scale_batch(torch.from_numpy(y))
    np.testing.assert_allclose(tfe.apply_rms_scale(torch.from_numpy(y), s).numpy(),
                               np.asarray(yj), rtol=1e-6, atol=1e-7)


def test_epilogue_ops_vs_jax():
    rng = np.random.default_rng(4)
    S = (rng.random((2, 50, 16)) ** 4).astype(np.float32)
    S[1] *= 1e-12
    db_j = np.asarray(jmel.power_to_db(jnp.asarray(S)))
    db_t = tmel.power_to_db(torch.from_numpy(S)).numpy()
    np.testing.assert_allclose(db_t, db_j, atol=1e-4)
    np.testing.assert_allclose(tmel.standardize(torch.from_numpy(db_j)).numpy(),
                               np.asarray(jmel.standardize(jnp.asarray(db_j))), atol=1e-5)
    for T in (20, 50, 63):
        assert np.array_equal(tmel.crop_or_pad_time(torch.from_numpy(S), T).numpy(),
                              np.asarray(jmel.crop_or_pad_time(jnp.asarray(S), T)))


def test_stft_power_vs_jax():
    cfg = MelConfig(**SMALL)
    y = _rows(cfg, 2, seed=5)
    kw = dict(n_fft=cfg.n_fft, hop_length=cfg.hop_length, num_frames=cfg.total_frames)
    ref = np.asarray(jstft.stft_power(jnp.asarray(y), **kw))
    got = tstft.stft_power(torch.from_numpy(y), **kw).numpy()
    np.testing.assert_allclose(got / ref.max(), ref / ref.max(), atol=2e-6)
    fr_j = np.asarray(jstft.frame_signal(jnp.asarray(y), **kw))
    fr_t = tstft.frame_signal(torch.from_numpy(y), **kw).numpy()
    assert np.array_equal(fr_t, fr_j)


def test_backend_gate_and_names():
    assert tfe.resolved_backend(MelConfig(), "cuda") == "cuda"
    assert tfe.resolved_backend(MelConfig(), "matmul") == "matmul"
    # only configs outside both kernel families resolve to the matmul
    # backends (config gate only); hop 160 is the ct family's, 240 the dense
    for hop in (160, 240):
        assert tfe.resolved_backend(MelConfig(hop_length=hop), "cuda") == "cuda"
    for hop in (441, 40):
        assert tfe.resolved_backend(MelConfig(hop_length=hop), "cuda") == "matmul"
    # the JAX kernel backends' names are not the port's
    for name in ("pallas", "pallas-bf16", "fft", "ct"):
        with pytest.raises(ValueError):
            tfe.resolved_backend(MelConfig(), name)
    with pytest.raises(NotImplementedError):
        tk.mel_power(torch.zeros(1, 16000), MelConfig(hop_length=441), num_frames=10)
    with pytest.raises(ValueError):  # wrong pre-padded length
        tk.mel_power(torch.zeros(1, 1000), MelConfig(), num_frames=626, pre_padded=True)
