"""The port's mel kernels over every hop family, held against the JAX package
on the CPU: the Cooley–Tukey plain version against the Pallas stack kernel
(interpret mode) at hop 96/160/320/512 and across frame tiles, the dense
plain version against the dense Pallas kernel, the frame range of the fast
frontend, the support gate and the wrapper's refusals. Tolerance: 2e-5 of the
mel power's max, the exact tier's bound of test_pallas_frontend.py. Inputs
come from numpy seeds and go to both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anuraxla.constants import MelConfig as JMel
from anuraxla.ops import frontend as jfe
from anuraxla.ops import pallas_frontend as jpf
from anuraxla_torch.constants import MelConfig
from anuraxla_torch.ops import frontend as tfe
from anuraxla_torch.ops import mel_kernel as tk

BASE = dict(sr=16000, n_mels=32, fmin=100.0, fmax=7500.0)
SMALL = dict(BASE, duration=0.5, hop_length=128, n_fft=256, target_frames=48)


def _rows(cfg, B, seed, special=False):
    """[B, num_samples] rows; ``special``: row 0 silent, row 1 clips after
    RMS scaling."""
    rng = np.random.default_rng(seed)
    y = (0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)
    if special:
        y[0] = 1e-7 * rng.standard_normal(cfg.num_samples)
        y[1] = 0.001 * rng.standard_normal(cfg.num_samples)
        y[1, :: cfg.num_samples // 5] = 0.9
    return y


def _close(got, ref, atol=2e-5):
    """Each row against its own max (a silent row's power is ~1e-12 of the
    others')."""
    got = np.asarray(got)
    m = ref.max(axis=(1, 2), keepdims=True)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got / m, ref / m, atol=atol)


def _pallas(y, cfg, **kw):
    return np.asarray(jpf.mel_power_pallas(jnp.asarray(y), JMel(**cfg), interpret=True, **kw))


@pytest.mark.parametrize("hop", [160, 96, 320, 512])
def test_ct_plain_vs_pallas_lane_phase_hops(hop):
    """hop % 32 == 0 (the reference's stack kernel with lane-phase copies):
    the port's one Cooley–Tukey kernel reads frames at any offset."""
    cfg = dict(BASE, duration=0.6, hop_length=hop, n_fft=2048, target_frames=16)
    tc = MelConfig(**cfg)
    y = _rows(tc, 2, seed=hop)
    T = tc.total_frames
    ref = _pallas(y, cfg, num_frames=T, algorithm="ct")
    got = tk.mel_power(torch.from_numpy(y), tc, num_frames=T, algorithm="ct")
    assert tk.kernel_name(tc, "ct", True) == ("mel_power_ct" if hop % 128 == 0 else "mel_power_ct_hop32")
    _close(got, ref)


def test_ct_plain_vs_pallas_hop160_multi_tile_with_scale():
    """hop 160 across more than one frame tile of either kernel (T > 128),
    with the RMS scale applied inline as the reference's stack path does."""
    cfg = dict(BASE, duration=2.0, hop_length=160, n_fft=2048, target_frames=160)
    tc = MelConfig(**cfg)
    y = _rows(tc, 2, seed=7, special=True)
    s = np.array(jfe.rms_scale_batch(jnp.asarray(y)))
    assert s[0] == -1.0 and s[1] > 0 and np.abs(y[1] * s[1]).max() > 1.0
    T = tc.total_frames
    assert T > 128
    ref = _pallas(y, cfg, num_frames=T, algorithm="ct", rms_scale=jnp.asarray(s))
    got = tk.mel_power(torch.from_numpy(y), tc, num_frames=T, rms_scale=torch.from_numpy(s))
    _close(got, ref)


@pytest.mark.parametrize("exact", [True, False])
def test_ct_plain_f64_sums_keep_the_rounding_points(exact):
    """``sums=torch.float64`` changes the sums' precision only. Exact mode:
    the f32 sums agree with it to f32 round-off. bf16 mode: the same rounding
    points, so the mean difference stays at round-off while single values
    differ by a flipped bf16 rounding (at most 2^-7 of a row's max)."""
    tc = MelConfig(**dict(BASE, duration=0.6, hop_length=160, n_fft=2048, target_frames=16))
    y = torch.from_numpy(np.pad(_rows(tc, 3, seed=11, special=True), ((0, 0), (1024, 1024))))
    s = tfe.rms_scale_batch(y)
    T = tc.total_frames
    f32 = tk.mel_power_ct_plain(y, s, tc, T, exact=exact)
    f64 = tk.mel_power_ct_plain(y, s, tc, T, exact=exact, sums=torch.float64)
    assert f64.dtype == torch.float32 and f64.shape == f32.shape
    rel = (f32 - f64).abs() / f64.abs().amax(dim=(1, 2), keepdim=True)
    assert float(rel.mean()) <= 2e-6
    assert float(rel.max()) <= (2e-6 if exact else 2.0**-7)
    if not exact:  # and the bf16 mode is not the exact one
        exact64 = tk.mel_power_ct_plain(y, s, tc, T, sums=torch.float64)
        assert float(((f64 - exact64).abs() / exact64.abs().amax(dim=(1, 2), keepdim=True)).mean()) > 1e-4


@pytest.mark.parametrize("cfg", [SMALL, dict(BASE, duration=0.5, hop_length=48, n_fft=256, target_frames=48),
                                 dict(BASE, duration=0.3, hop_length=80, n_fft=400, target_frames=16)],
                         ids=["hop128_n256", "hop48_n256", "hop80_n400"])
def test_dense_plain_vs_pallas(cfg):
    """The dense kernel's plain version against the dense Pallas kernel: on a
    config the ct kernel also takes, on one only dense takes (hop % 16), and
    at an n_fft that is no multiple of 128."""
    tc = MelConfig(**cfg)
    y = _rows(tc, 3, seed=11, special=True)
    s = np.array(jfe.rms_scale_batch(jnp.asarray(y)))
    T = tc.total_frames
    ref = _pallas(y, cfg, num_frames=T, algorithm="dense", rms_scale=jnp.asarray(s))
    got = tk.mel_power(torch.from_numpy(y), tc, num_frames=T, algorithm="dense", rms_scale=torch.from_numpy(s))
    _close(got, ref)
    if not tk.kernel_supported(tc, "ct"):
        auto = tk.mel_power(torch.from_numpy(y), tc, num_frames=T, rms_scale=torch.from_numpy(s))
        assert torch.equal(auto, got)  # "auto" falls to dense where ct cannot go
    # bf16 mode: the reference's DEFAULT precision is f32 on a CPU, so the
    # port's rounded operands are held to the bf16 tier's 1e-2
    ref16 = _pallas(y, cfg, num_frames=T, algorithm="dense", exact=False, rms_scale=jnp.asarray(s))
    got16 = tk.mel_power(torch.from_numpy(y), tc, num_frames=T, algorithm="dense", exact=False,
                         rms_scale=torch.from_numpy(s))
    _close(got16, ref16, atol=1e-2)
    assert not torch.equal(got16, got)


def test_dense_tables_match_reference():
    args = (16000, 400, 32, 100.0, 7500.0)
    for got, want in zip(tk.dense_tables(*args), jpf._padded_tables(*args)):
        assert got.dtype == np.float32 and got.flags.c_contiguous
        assert np.array_equal(got, want)
    assert tk.dense_tables(*args)[0].shape == (400, 256)


@pytest.mark.parametrize("algorithm,cfg", [
    ("ct", dict(BASE, duration=1.5, hop_length=128, n_fft=256, target_frames=48)),
    ("ct", dict(BASE, duration=1.0, hop_length=160, n_fft=512, target_frames=32)),
    ("dense", dict(BASE, duration=1.0, hop_length=80, n_fft=400, target_frames=32)),
])
def test_frame_range_matches_sliced_reference(algorithm, cfg):
    """``first_frame``: the port computes only the fast frontend's frames;
    the reference computes from frame 0 and slices."""
    tc = MelConfig(**cfg)
    total = tc.total_frames
    num = min(tc.target_frames, total)
    first = max(0, (total - tc.target_frames) // 2)
    assert first > 0
    y = _rows(tc, 2, seed=13)
    ref = _pallas(y, cfg, num_frames=first + num, algorithm=algorithm)[:, first:]
    for exact in (True, False):
        got = tk.mel_power(torch.from_numpy(y), tc, num_frames=num, first_frame=first,
                           algorithm=algorithm, exact=exact)
        full = tk.mel_power(torch.from_numpy(y), tc, num_frames=first + num, algorithm=algorithm, exact=exact)
        assert torch.equal(got, full[:, first:])
        if exact:
            _close(got, ref)
    if algorithm == "ct" and tc.hop_length % 128 == 0:
        # pre-padded rows in the fast frontend's (truncated) layout
        L_pad, off = tk.phase_padded_layout(tc, first + num)
        keep = min(tc.num_samples, L_pad - off)
        yp = np.zeros((2, L_pad), np.float32)
        yp[:, off : off + keep] = y[:, :keep]
        got_p = tk.mel_power(torch.from_numpy(yp), tc, num_frames=num, first_frame=first, pre_padded=True)
        _close(got_p, ref)


HOPS = (40, 48, 80, 96, 100, 128, 160, 240, 320, 384, 441, 512)


@pytest.mark.parametrize("n_fft", [200, 256, 384, 400, 2048])
def test_support_gate_pinned_to_reference(n_fft):
    """Which configs reach a kernel: the port's gate is the reference's
    ``pallas_supported``, and only configs outside both families resolve to
    the matmul backends."""
    for hop in HOPS:
        kw = dict(sr=48000, duration=1.0, hop_length=hop, n_fft=n_fft)
        tc, jc = MelConfig(**kw), JMel(**kw)
        for alg in ("auto", "ct", "dense"):
            assert tk.kernel_supported(tc, alg) == tk.kernel_takes(tc, alg) == jpf.pallas_supported(jc, alg)
        taken = jpf.pallas_supported(jc)
        assert tfe.resolved_backend(tc, "cuda") == ("cuda" if taken else "matmul")
        assert tfe.resolved_backend(tc, "cuda-bf16") == ("cuda-bf16" if taken else "matmul-bf16")
        for name in ("matmul", "matmul-bf16"):
            assert tfe.resolved_backend(tc, name) == name
        if taken:
            want = "ct" if jpf.pallas_supported(jc, "ct") else "dense"
            assert tk.resolve_algorithm(tc) == want
    # more mels than the kernels hold in registers: a config no kernel takes
    wide = MelConfig(n_mels=160)
    assert tk.kernel_supported(wide) and not tk.kernel_takes(wide)
    assert tfe.resolved_backend(wide, "cuda") == "matmul"


def test_kernel_names():
    d, h160, h240 = MelConfig(), MelConfig(hop_length=160), MelConfig(hop_length=240)
    assert tk.kernel_name(d, "ct", True) == "mel_power_ct"
    assert tk.kernel_name(h160, "ct", True) == "mel_power_ct_hop32"
    assert tk.kernel_name(d, "ct", False) == tk.kernel_name(h160, "ct", False) == "mel_power_ct_bf16"
    assert tk.kernel_name(h240, "dense", True) == "mel_power_dense"
    assert tk.kernel_name(d, "dense", False) == "mel_power_dense_bf16"
    assert set(tk.mel_power.launches) == set(tk.KERNEL_NAMES)
    assert not any(tk.mel_power.launches.values())  # no CPU call counts a launch


def test_wrapper_refusals_match_reference():
    """The validity checks of ``mel_power_pallas`` carry over with the same
    exception types."""
    y = torch.zeros(1, 16000)
    cases = [
        (dict(hop_length=100), dict()),                      # neither family
        (dict(hop_length=48, n_fft=256), dict(algorithm="ct")),
        (dict(hop_length=128, n_fft=200), dict(algorithm="ct")),
        (dict(hop_length=40), dict(algorithm="dense")),
    ]
    for cfg_kw, kw in cases:
        with pytest.raises(NotImplementedError):
            tk.mel_power(y, MelConfig(**cfg_kw), num_frames=8, **kw)
        with pytest.raises(NotImplementedError):
            jpf.mel_power_pallas(jnp.zeros((1, 16000)), JMel(**cfg_kw), num_frames=8, interpret=True, **kw)
    with pytest.raises(NotImplementedError):
        tk.mel_power(y, MelConfig(n_mels=160), num_frames=8)
    # pre_padded is the hop % 128 == 0 ct contract, in both packages
    for cfg_kw, kw in [(dict(hop_length=160), dict()), (dict(), dict(algorithm="dense"))]:
        with pytest.raises(ValueError, match="pre_padded"):
            tk.mel_power(y, MelConfig(**cfg_kw), num_frames=8, pre_padded=True, **kw)
        with pytest.raises(ValueError, match="pre_padded"):
            jpf.mel_power_pallas(jnp.zeros((1, 16000)), JMel(**cfg_kw), num_frames=8, interpret=True,
                                 pre_padded=True, **kw)
    with pytest.raises(ValueError):
        tk.mel_power(y, MelConfig(), num_frames=8, algorithm="fft")
    with pytest.raises(ValueError):
        tk.mel_power(y, MelConfig(), num_frames=0)
    with pytest.raises(ValueError):
        tk.mel_power(y, MelConfig(), num_frames=8, first_frame=-1)
    with pytest.raises(ValueError):
        tk.mel_power(y, MelConfig(), num_frames=8, rms_scale=torch.ones(3))
