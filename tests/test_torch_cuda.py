"""The port's Hopper kernels and their wrapper on the card: each kernel and
mode against its plain PyTorch version (exact: 2e-5 of each row's max, the
exact tier's bound; bf16: 3e-3 for the largest difference — a flipped bf16
rounding of a dominant power value, as chip_smoke.py shows against f64 sums —
and 2e-5 for the mean), launch counting
by kernel and mode, the wrapper's refusals on a CUDA tensor, the sessions
on the card against the same sessions on the CPU (``encode_paths`` through
the pinned host slots too), the radial and MAP fits on the card against
the same fits on the CPU, the conv VAE's train step on the card against
the same steps on the CPU, and the window expansion kernel bit for bit its
plain version, through the session against the host route's rows.

These tests need an NVIDIA card and ``nvcc``; elsewhere they skip. The
card's machine has no JAX, so this file imports none and runs without the
test suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

import json

import numpy as np
import pytest
import torch

from anuraxla_torch.cli import evaluate_wav as t_cli
from anuraxla_torch.constants import DEFAULT_MEL, PRIORITY_ORDER, MelConfig
from anuraxla_torch.ops import frontend as tfe
from anuraxla_torch.ops import mel_kernel as tk
from anuraxla_torch.ops.window_expand import window_expand, window_expand_plain
from anuraxla_torch.pipeline.session import EncoderSession
from anuraxla_torch.utils.wavio import read_wav, write_wav

pytestmark = pytest.mark.cuda

SMALL = dict(sr=16000, duration=0.5, n_mels=32, fmin=100.0, fmax=7500.0,
             hop_length=128, n_fft=256, target_frames=48)
R16 = dict(sr=48000, duration=1.0, n_mels=64, fmin=150.0, fmax=15000.0,
           hop_length=384, n_fft=2048, target_frames=64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card's machine)")
    return torch.device("cuda")


def _rows(cfg, B, seed):
    """[B, num_samples] rows: row 0 silent, row 1 clips after RMS scaling."""
    rng = np.random.default_rng(seed)
    y = (0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)
    y[0] = 1e-7 * rng.standard_normal(cfg.num_samples)
    y[1] = 0.001 * rng.standard_normal(cfg.num_samples)
    y[1, :: cfg.num_samples // 5] = 0.9
    return y


def _launches():
    return dict(tk.mel_power.launches)


@pytest.mark.parametrize("cfg", [SMALL, R16, dict(R16, hop_length=512, n_fft=1024)], ids=["small", "r16", "r8"])
@pytest.mark.parametrize("pre_padded", [True, False])
def test_kernel_matches_plain(card, cfg, pre_padded):
    cfg = MelConfig(**cfg)
    y = _rows(cfg, 3, seed=1)
    T = cfg.total_frames
    if pre_padded:
        L_pad, off = tk.phase_padded_layout(cfg, T)
        yp = np.zeros((3, L_pad), np.float32)
        yp[:, off : off + cfg.num_samples] = y
        y = yp
    x = torch.from_numpy(y).to(card)
    s = tfe.rms_scale_batch(torch.from_numpy(_rows(cfg, 3, seed=1)).to(card))
    assert float(s[0]) == -1.0 and float(s[1]) > 0
    n0 = _launches()
    got = tk.mel_power(x, cfg, num_frames=T, rms_scale=s, pre_padded=pre_padded)
    assert _launches() == dict(n0, mel_power_ct=n0["mel_power_ct"] + 1)
    if not pre_padded:
        x = torch.nn.functional.pad(x, (cfg.n_fft // 2, cfg.n_fft // 2))
    ref = tk.mel_power_ct_plain(x, s, cfg, T)
    assert got.shape == ref.shape == (3, T, cfg.n_mels) and got.device.type == "cuda"
    # each row against its own max: the silent row's power is ~1e-12 of the others'
    rel = (got - ref).abs().amax(dim=(1, 2)) / ref.abs().amax(dim=(1, 2))
    assert float(rel.max()) <= 2e-5, rel


H160 = dict(R16, hop_length=160)
DENSE = dict(R16, hop_length=240, duration=0.5)
DENSE_ODD = dict(SMALL, hop_length=80, n_fft=400)
MODES = [
    # (config, algorithm, exact, fast frame range, counter)
    (R16, "ct", False, False, "mel_power_ct_bf16"),
    (dict(R16, duration=2.0), "ct", False, True, "mel_power_ct_bf16"),
    (dict(R16, duration=2.0), "ct", True, True, "mel_power_ct"),
    (H160, "ct", True, False, "mel_power_ct_hop32"),
    (dict(R16, hop_length=96, n_fft=512), "ct", True, True, "mel_power_ct_hop32"),
    (H160, "ct", False, False, "mel_power_ct_bf16"),
    (DENSE, "dense", True, False, "mel_power_dense"),
    (DENSE, "auto", True, True, "mel_power_dense"),
    (DENSE_ODD, "dense", True, False, "mel_power_dense"),
    (R16, "dense", True, False, "mel_power_dense"),
    (DENSE, "dense", False, False, "mel_power_dense_bf16"),
    (DENSE_ODD, "auto", False, False, "mel_power_dense_bf16"),
]


@pytest.mark.parametrize("cfg,algorithm,exact,fast,counter", MODES,
                         ids=[f"{m[4]}-{i}" for i, m in enumerate(MODES)])
def test_new_kernels_and_modes_match_plain(card, cfg, algorithm, exact, fast, counter):
    cfg = MelConfig(**cfg)
    total = cfg.total_frames
    first, T = (max(0, (total - cfg.target_frames) // 2), min(cfg.target_frames, total)) if fast else (0, total)
    assert not fast or first > 0
    x = torch.from_numpy(_rows(cfg, 4, seed=2)).to(card)
    s = tfe.rms_scale_batch(x)
    n0 = _launches()
    got = tk.mel_power(x, cfg, num_frames=T, first_frame=first, rms_scale=s, exact=exact, algorithm=algorithm)
    assert _launches() == dict(n0, **{counter: n0[counter] + 1})
    plain = tk.mel_power_dense_plain if counter.startswith("mel_power_dense") else tk.mel_power_ct_plain
    ref = plain(torch.nn.functional.pad(x, (cfg.n_fft // 2, cfg.n_fft // 2)), s, cfg, T,
                first_frame=first, exact=exact)
    assert got.shape == ref.shape == (4, T, cfg.n_mels)
    rel = (got - ref).abs() / ref.abs().amax(dim=(1, 2), keepdim=True)
    assert float(rel.max()) <= (2e-5 if exact else 3e-3), rel.amax(dim=(1, 2))
    assert float(rel.mean()) <= 2e-5
    # the frame range is the full computation sliced, bit for bit
    if fast:
        full = tk.mel_power(x, cfg, num_frames=first + T, rms_scale=s, exact=exact, algorithm=algorithm)
        assert torch.equal(got, full[:, first:])


DENSE_TILE_CASES = [
    # (config, exact, the tile dense_tile picks: frames a block, k16 steps a ring buffer, buffers)
    (DENSE, True, (128, 4, 3)),
    (dict(R16, hop_length=496, duration=1.0), True, (64, 4, 3)),
    (dict(R16, hop_length=1008, duration=2.0), True, (32, 4, 3)),
    (dict(R16, hop_length=1744, duration=2.0), True, (16, 4, 3)),
    (dict(R16, hop_length=2112, duration=2.0), True, (16, 1, 2)),  # frames apart, a small ring
    (dict(R16, hop_length=1744, duration=2.0), False, (32, 4, 3)),
    (dict(R16, hop_length=1008, duration=2.0), False, (64, 4, 3)),
    (dict(DENSE_ODD, n_mels=20), False, (128, 4, 3)),  # a ragged mel tile
]


@pytest.mark.parametrize("cfg,exact,tile", DENSE_TILE_CASES,
                         ids=[f"{i}-{'exact' if m[1] else 'bf16'}-tf{m[2][0]}" for i, m in enumerate(DENSE_TILE_CASES)])
def test_dense_kernel_every_tile_matches_split_plain(card, cfg, exact, tile):
    """The dense kernel at each of its tiles (forced by the config's shared
    memory) against the plain version of its split arithmetic, on a frame
    range; the exact mode also against plain f32. The kernel's shared memory
    is the host's formula for every tile."""
    cfg = MelConfig(**cfg)
    assert tk.dense_tile(cfg.n_fft, cfg.hop_length, exact) == tile
    lib = tk._lib("mel_power_dense")
    for t in tk.DENSE_TILES:
        want = tk.dense_smem_bytes(cfg.n_fft, cfg.hop_length, t, exact)
        assert lib.mel_power_dense_smem_bytes(cfg.n_fft, cfg.hop_length, *t, int(not exact)) == want
    x = torch.from_numpy(_rows(cfg, 3, seed=9)).to(card)
    s = tfe.rms_scale_batch(x)
    first, T = 1, cfg.total_frames - 2
    counter = "mel_power_dense" if exact else "mel_power_dense_bf16"
    n0 = _launches()
    got = tk.mel_power(x, cfg, num_frames=T, first_frame=first, rms_scale=s, exact=exact, algorithm="dense")
    assert _launches() == dict(n0, **{counter: n0[counter] + 1})
    centred = torch.nn.functional.pad(x, (cfg.n_fft // 2, cfg.n_fft // 2))
    ref = tk.mel_power_dense_split_plain(centred, s, cfg, T, first_frame=first, exact=exact)
    assert got.shape == ref.shape == (3, T, cfg.n_mels) and torch.isfinite(got).all()
    rel = (got - ref).abs() / ref.abs().amax(dim=(1, 2), keepdim=True)
    assert float(rel.max()) <= (2e-5 if exact else 3e-3), rel.amax(dim=(1, 2))
    assert float(rel.mean()) <= 2e-5
    if exact:
        f32 = tk.mel_power_dense_plain(centred, s, cfg, T, first_frame=first)
        assert float(((got - f32).abs() / f32.abs().amax(dim=(1, 2), keepdim=True)).max()) <= 2e-5


FUSED = [
    # (config, exact, fast frame range, pre-padded rows)
    (R16, True, False, True),
    (R16, False, False, False),
    (dict(R16, duration=2.0), True, True, False),
    (dict(R16, duration=2.0), False, True, False),
    (dict(R16, hop_length=320), True, False, False),
    (H160, False, False, False),
    (dict(R16, hop_length=512, n_fft=1024), True, False, True),
    (SMALL, True, False, True),  # R = 2: no complex r
    (SMALL, False, False, False),
    (dict(SMALL, n_fft=384, n_mels=20), True, False, False),  # odd R, a ragged mel tile
]


@pytest.mark.parametrize("cfg,exact,fast,pre_padded", FUSED,
                         ids=[f"{i}-{'exact' if m[1] else 'bf16'}" for i, m in enumerate(FUSED)])
def test_fused_kernel_matches_plain(card, cfg, exact, fast, pre_padded):
    """``fused_dots=True`` on the card (the split kernel: TMA ring, wgmma)
    against its plain version, and the exact mode against plain f32 too, at
    odd B = 3 and 5."""
    cfg = MelConfig(**cfg)
    total = cfg.total_frames
    first, T = (max(0, (total - cfg.target_frames) // 2), min(cfg.target_frames, total)) if fast else (0, total)
    counter = "mel_power_ct_fused" if exact else "mel_power_ct_fused_bf16"
    for B in (3, 5):
        raw = torch.from_numpy(_rows(cfg, B, seed=7)).to(card)
        s = tfe.rms_scale_batch(raw)
        pad = cfg.n_fft // 2
        x, centred = raw, torch.nn.functional.pad(raw, (pad, pad))
        if pre_padded:
            L_pad, off = tk.phase_padded_layout(cfg, T)
            x = centred = torch.nn.functional.pad(raw, (off, L_pad - off - cfg.num_samples))
        ref = tk.mel_power_ct_fused_plain(centred, s, cfg, T, first_frame=first, exact=exact)
        f32 = tk.mel_power_ct_plain(centred, s, cfg, T, first_frame=first) if exact else None
        n0 = _launches()
        got = tk.mel_power(x, cfg, num_frames=T, first_frame=first, rms_scale=s, pre_padded=pre_padded,
                           exact=exact, fused_dots=True)
        assert _launches() == dict(n0, **{counter: n0[counter] + 1})
        assert got.shape == ref.shape == (B, T, cfg.n_mels) and torch.isfinite(got).all()
        rel = (got - ref).abs() / ref.abs().amax(dim=(1, 2), keepdim=True)
        assert float(rel.max()) <= (2e-5 if exact else 3e-3), (B, rel.amax(dim=(1, 2)))
        assert float(rel.mean()) <= 2e-5
        if exact:  # the split scheme holds the exact tier's gate against plain f32
            assert float(((got - f32).abs() / f32.abs().amax(dim=(1, 2), keepdim=True)).max()) <= 2e-5


BF16_CLASSES = tuple(c for c in tk.ABLATE_CLASSES if c not in tk.EXACT_ONLY_CLASSES)
ABLATED = ([(c,) for c in tk.ABLATE_CLASSES] + [tk.ABLATE_CLASSES, ("window", "fb"), ("splits", "fb")],
           [(c,) for c in BF16_CLASSES] + [BF16_CLASSES, ("window", "fb")])


@pytest.mark.parametrize("classes,exact", [(c, e) for e in (True, False) for c in ABLATED[not e]],
                         ids=lambda v: "+".join(v) if isinstance(v, tuple) else ("exact" if v else "bf16"))
@pytest.mark.parametrize("cfg", [R16, dict(R16, hop_length=512, n_fft=1024)], ids=["r16", "r8"])
def test_ablated_kernel_matches_ablated_plain(card, cfg, classes, exact):
    """Each ablated instantiation drops what the ablated plain version drops
    (wrong output by design; the exact mode's twin is the split arithmetic,
    ``mel_power_ct_split_plain``), held to the mode's gate; its launch counts
    under the kernel's own name."""
    cfg = MelConfig(**cfg)
    T = cfg.total_frames
    raw = torch.from_numpy(_rows(cfg, 3, seed=8)).to(card)
    s = tfe.rms_scale_batch(raw)
    counter = "mel_power_ct" if exact else "mel_power_ct_bf16"
    n0 = _launches()
    got = tk.mel_power(raw, cfg, num_frames=T, rms_scale=s, exact=exact, ablate=classes)
    assert _launches() == dict(n0, **{counter: n0[counter] + 1})
    pad = cfg.n_fft // 2
    centred = torch.nn.functional.pad(raw, (pad, pad))
    ref = tk.mel_power_ct_split_plain(centred, s, cfg, T, exact=exact, ablate=classes)
    rel = (got - ref).abs() / ref.abs().amax(dim=(1, 2), keepdim=True)
    # bf16 with the power dropped rounds a signed p and the filterbank sum cancels, so
    # one term can exceed the row's max: a flipped rounding is held to a bf16 step
    # (2^-7) of a term twice that max, not to 3e-3; the mean carries the check.
    # 'splits' (lo = -hi) makes every product a difference of two terms ~2^8 larger
    # than itself, in both stages, so the accumulators' rounding shows ~2^16 larger:
    # the same held step. 'dots' is one bf16 pass: the bf16 mode's gate
    signed_p = "power" in classes and "fb" not in classes
    if exact and "splits" not in classes and "dots" not in classes:
        tol = 2e-5
    elif signed_p or "splits" in classes:
        tol = 2.0 ** -6
    else:
        tol = 3e-3
    assert float(rel.max()) <= tol, rel.amax(dim=(1, 2))
    assert float(rel.mean()) <= 2e-5
    intact = tk.mel_power_ct_plain(centred, s, cfg, T, exact=exact)
    dropped = 5e-4 if classes == ("dots",) else 1e-2  # one pass moves it by ~2e-3 of the max
    assert float((got - intact).abs().max() / intact.abs().max()) > dropped  # dropped, not ignored


CT_CASES = [
    # (config, exact, first_frame, pre-padded rows, the frame tile ct_tile picks)
    (SMALL, True, 0, True, 64),                                        # R = 2: no complex r
    (dict(SMALL, n_fft=512, hop_length=96, n_mels=20), True, 3, False, 64),  # R = 4, a ragged mel tile
    (dict(R16, n_mels=128), True, 5, True, 64),                        # R = 16, 128 mels
    (dict(R16, n_fft=4096, hop_length=512, duration=2.0), True, 0, False, 32),  # R = 32
    (dict(R16, hop_length=160), False, 2, False, 64),
    (dict(R16, n_fft=4096, hop_length=512, duration=2.0, n_mels=128), False, 1, False, 64),
    (dict(R16, hop_length=1120, duration=3.0), True, 1, False, 32),   # the longest hop the FP32 kernel took
    (dict(R16, hop_length=2048, duration=4.0, n_mels=20), True, 0, False, 16),  # the smallest tile
    (dict(R16, hop_length=2048, duration=4.0), False, 1, False, 16),
]


@pytest.mark.parametrize("cfg,exact,first,pre_padded,tf", CT_CASES,
                         ids=[f"{i}-{'exact' if m[1] else 'bf16'}-tf{m[4]}" for i, m in enumerate(CT_CASES)])
def test_ct_kernel_matches_split_plain(card, cfg, exact, first, pre_padded, tf):
    """The Cooley–Tukey kernel at R = 2, 4, 16 and 32, hop % 128 with
    pre-padded rows and hop % 32, frame ranges, 20 / 64 / 128 mels and each
    of its frame tiles, against the plain version of its split arithmetic
    (exact: 2e-5 of each row's max; bf16: 3e-3 worst, 2e-5 mean) and, exact,
    against plain f32 at 2e-5. The kernel's shared memory is the host's
    formula for every tile."""
    cfg = MelConfig(**cfg)
    assert tk.ct_tile(cfg.n_fft, cfg.hop_length, exact) == tf
    lib = tk._lib("mel_power_ct")
    for t in tk.CT_TILES:
        want = tk.ct_smem_bytes(cfg.n_fft, cfg.hop_length, t, exact)
        assert lib.mel_power_ct_smem_bytes(cfg.n_fft, cfg.hop_length, t, int(not exact)) == want
    raw = torch.from_numpy(_rows(cfg, 3, seed=10)).to(card)
    s = tfe.rms_scale_batch(raw)
    T = cfg.total_frames - first - 1
    pad = cfg.n_fft // 2
    x, centred = raw, torch.nn.functional.pad(raw, (pad, pad))
    if pre_padded:
        L_pad, off = tk.phase_padded_layout(cfg, first + T)
        x = centred = torch.nn.functional.pad(raw, (off, L_pad - off - cfg.num_samples))
    counter = tk.kernel_name(cfg, "ct", exact)
    n0 = _launches()
    got = tk.mel_power(x, cfg, num_frames=T, first_frame=first, rms_scale=s, pre_padded=pre_padded, exact=exact)
    assert _launches() == dict(n0, **{counter: n0[counter] + 1})
    ref = tk.mel_power_ct_split_plain(centred, s, cfg, T, first_frame=first, exact=exact)
    assert got.shape == ref.shape == (3, T, cfg.n_mels) and torch.isfinite(got).all()
    rel = (got - ref).abs() / ref.abs().amax(dim=(1, 2), keepdim=True)
    assert float(rel.max()) <= (2e-5 if exact else 3e-3), rel.amax(dim=(1, 2))
    assert float(rel.mean()) <= 2e-5
    if exact:
        f32 = tk.mel_power_ct_plain(centred, s, cfg, T, first_frame=first)
        assert float(((got - f32).abs() / f32.abs().amax(dim=(1, 2), keepdim=True)).max()) <= 2e-5


def test_study_options_refuse_on_cuda(card):
    cfg = MelConfig(**R16)
    x = torch.zeros((2, cfg.num_samples), device=card)
    for kw, reason in ((dict(ablate=("shifts",)), "any sample offset"),
                       (dict(ablate=("dots",), exact=False), "no split/multi-pass"),
                       (dict(ablate=("power",), fused_dots=True), "fused-dots"),
                       (dict(fused_dots=True, algorithm="dense"), "algorithm 'ct'")):
        with pytest.raises(ValueError, match=reason):
            tk.mel_power(x, cfg, num_frames=8, **kw)
    with pytest.raises(ValueError, match="hop % 128"):
        tk.mel_power(x, cfg.replace(hop_length=320), num_frames=8, ablate=("fb",))
    with pytest.raises(NotImplementedError, match="shared memory"):
        tk.mel_power(x, cfg.replace(hop_length=4096), num_frames=4, fused_dots=True)


def test_wrapper_refuses_on_cuda(card):
    x = torch.zeros((2, 16000), device=card)
    with pytest.raises(NotImplementedError):  # a config no kernel takes
        tk.mel_power(x, MelConfig(hop_length=441), num_frames=10)
    with pytest.raises(NotImplementedError):  # ct cannot take hop % 32 != 0
        tk.mel_power(x, MelConfig(hop_length=240), num_frames=10, algorithm="ct")
    with pytest.raises(NotImplementedError):
        tk.mel_power(x, MelConfig(n_mels=160), num_frames=10)
    with pytest.raises(NotImplementedError, match="shared memory"):  # past even 16 frames a block
        tk.mel_power(x, MelConfig(hop_length=4096), num_frames=4)
    with pytest.raises(ValueError):
        tk.mel_power(x, MelConfig(), num_frames=10, algorithm="fft")
    with pytest.raises(ValueError):
        tk.mel_power(x, MelConfig(), num_frames=10, first_frame=-1)
    for kw in (dict(cfg=MelConfig(hop_length=160)), dict(cfg=MelConfig(), algorithm="dense")):
        with pytest.raises(ValueError, match="pre_padded"):  # the hop % 128 == 0 ct contract
            tk.mel_power(x, kw.pop("cfg"), num_frames=10, pre_padded=True, **kw)
    cfg = MelConfig(**SMALL)
    T = cfg.total_frames
    y = torch.zeros((2, cfg.num_samples), device=card)
    with pytest.raises(ValueError):
        tk.mel_power(y.double(), cfg, num_frames=T)
    L_pad, _ = tk.phase_padded_layout(cfg, T)
    with pytest.raises(ValueError):  # pre-padded rows go to the kernel as given
        tk.mel_power(torch.zeros((L_pad, 2), device=card).t(), cfg, num_frames=T, pre_padded=True)
    with pytest.raises(ValueError):  # the fast range's layout is shorter than the full clip's
        tk.mel_power(torch.zeros((2, L_pad), device=card), cfg, num_frames=T + 200, pre_padded=True)
    with pytest.raises(ValueError):  # scale on another device
        tk.mel_power(y, cfg, num_frames=T, rms_scale=torch.ones(2))
    # only the config gate carries over: a kernel backend resolves to its
    # matmul frontend for a config no kernel takes, and launches nothing
    n0 = _launches()
    other = MelConfig(sr=16000, duration=0.5, hop_length=441, n_fft=512, n_mels=32, target_frames=16)
    for backend in ("cuda", "cuda-bf16"):
        for parity in (True, False):
            out = tfe.log_mel_batch(torch.zeros((2, other.num_samples), device=card), other,
                                    backend=backend, parity=parity)
            assert out.shape == (2, 16, 32)
    assert _launches() == n0
    # while a config of the dense family now reaches its kernel
    dense = other.replace(hop_length=80, n_fft=400)
    tfe.log_mel_batch(torch.zeros((2, dense.num_samples), device=card), dense, backend="cuda")
    assert _launches() == dict(n0, mel_power_dense=n0["mel_power_dense"] + 1)


def test_session_on_card_matches_cpu(card):
    cfg = DEFAULT_MEL.replace(duration=1.0)
    rng = np.random.default_rng(2)
    audio = (0.1 * rng.standard_normal((3, cfg.num_samples))).astype(np.float32)
    audio[2] = 0.0
    kw = dict(mel=cfg, normalize_on_device=True, pre_padded_host=True, init_seed=3)
    n0 = _launches()
    Zg = EncoderSession(**kw, device="cuda").load().encode_array(audio)
    assert _launches()["mel_power_ct"] > n0["mel_power_ct"]
    Zc = EncoderSession(**kw, device="cpu").load().encode_array(audio)
    np.testing.assert_allclose(Zg, Zc, rtol=5e-4, atol=2e-5)


@pytest.mark.parametrize("hop,counter", [(384, "mel_power_ct_bf16"), (320, "mel_power_ct_bf16"),
                                         (240, "mel_power_dense_bf16")])
def test_fast_tier_session_on_card_matches_cpu(card, hop, counter):
    """The fast tier (crop-first frontend, bf16 kernel) on the card against
    the CPU's plain bf16 version: both round at the same points, so with an
    f32 trunk the latents agree to cosine >= 0.999; the bf16 trunk on top
    stays within 0.99."""
    cfg = DEFAULT_MEL.replace(duration=6.0, hop_length=hop)
    rng = np.random.default_rng(4)
    t = np.arange(cfg.num_samples) / cfg.sr
    audio = np.stack([0.2 * np.sin(2 * np.pi * f * t) for f in (900.0, 2500.0, 6100.0)])
    audio = (audio + 0.02 * rng.standard_normal(audio.shape)).astype(np.float32)
    kw = dict(mel=cfg, normalize_on_device=True, parity=False, backend="cuda-bf16", init_seed=3)
    n0 = _launches()
    Zg = EncoderSession(**kw, device="cuda").load().encode_array(audio)
    assert _launches() == dict(n0, **{counter: n0[counter] + 1})
    Zc = EncoderSession(**kw, device="cpu").load().encode_array(audio)
    cos = (Zg * Zc).sum(1) / (np.linalg.norm(Zg, axis=1) * np.linalg.norm(Zc, axis=1))
    assert np.isfinite(Zg).all() and cos.min() >= 0.999, cos
    Zb = EncoderSession(**kw, device="cuda", encoder_dtype="bfloat16").load().encode_array(audio)
    cosb = (Zb * Zg).sum(1) / (np.linalg.norm(Zb, axis=1) * np.linalg.norm(Zg, axis=1))
    assert cosb.min() > 0.99, cosb


@pytest.mark.parametrize("hop,counter", [(320, "mel_power_ct_hop32"), (240, "mel_power_dense")])
def test_parity_session_other_hops_on_card_matches_cpu(card, hop, counter):
    cfg = DEFAULT_MEL.replace(duration=1.0, hop_length=hop)
    rng = np.random.default_rng(5)
    audio = (0.1 * rng.standard_normal((3, cfg.num_samples))).astype(np.float32)
    kw = dict(mel=cfg, normalize_on_device=True, init_seed=3)
    n0 = _launches()
    s = EncoderSession(**kw, device="cuda").load()
    Zg = s.encode_array(audio)
    assert _launches() == dict(n0, **{counter: n0[counter] + 1})
    Zc = EncoderSession(**kw, device="cpu").load().encode_array(audio)
    np.testing.assert_allclose(Zg, Zc, rtol=5e-4, atol=2e-5)
    # reconfigure retargets the loaded session: the fast frontend through the bf16 kernel
    s.reconfigure(parity=False, backend="cuda-bf16")
    assert np.isfinite(s.encode_array(audio)).all()
    assert sum(_launches().values()) == sum(n0.values()) + 2


@pytest.mark.parametrize("tier", ["parity", "balanced", "fast"])
def test_cli_serving_tier_on_card(card, tier, tmp_path, capsys):
    """``evaluate_wav --serving-tier`` on the card: exit 0 with the ✅ line on
    a detect, 2 with ❌, the decisions the same tier gives on the CPU; each
    call launches the tier's kernel."""
    cfg = DEFAULT_MEL.replace(duration=5.0)
    rng = np.random.default_rng(6)
    t = np.arange(cfg.num_samples) / cfg.sr
    paths = []
    for i, f in enumerate((800.0, 5200.0)):
        y = 0.3 * np.sin(2 * np.pi * f * t) * (rng.random(t.size) > 0.3) + 0.02 * rng.standard_normal(t.size)
        paths.append(tmp_path / f"c{i}.wav")
        write_wav(paths[-1], y.astype(np.float32), cfg.sr)
    sess = EncoderSession(mel=cfg, device="cpu", init_seed=7).load()
    Z = sess.encode_array(np.stack([read_wav(p)[0] for p in paths]))
    sp = PRIORITY_ORDER[0]
    (tmp_path / "config.json").write_text(json.dumps({
        "species": [sp], "chunk_seconds": 5.0,
        "radial_detector": {"centroids": {sp: Z[0].tolist()},
                            "thresholds": {sp: 0.5 * float(np.linalg.norm(Z[1] - Z[0]))}}}))
    counter = "mel_power_ct_bf16" if tier == "fast" else "mel_power_ct"
    for p, code, mark in ((paths[0], 0, "✅ DETECTED: " + sp), (paths[1], 2, "❌ NO DETECT")):
        for device in ("cuda", "cpu"):
            n0 = _launches()
            with pytest.raises(SystemExit) as e:
                t_cli.main(["--wav", str(p), "--config", str(tmp_path / "config.json"), "--init-seed", "7",
                            "--serving-tier", tier, "--device", device])
            assert e.value.code == code
            assert mark in capsys.readouterr().out
            assert _launches() == dict(n0, **{counter: n0[counter] + (device == "cuda")})


def _latents(K=4, n=48, D=128, seed=9):
    """Padded [K, n, D] latents, one cluster per species, a ragged last class."""
    rng = np.random.default_rng(seed)
    centers = 2.0 * rng.standard_normal((K, D))
    Z = (centers[:, None, :] + rng.standard_normal((K, n, D))).astype(np.float32)
    mask = np.ones((K, n), bool)
    mask[-1, n - 7:] = False
    return Z, mask


def _row_rel(a, b):
    return float((np.abs(a - b).max(axis=1) / np.abs(b).max(axis=1)).max())


def test_fits_on_card_match_cpu(card):
    """The radial and MAP fits on the card against the same fits on the CPU
    from the same latents (``chip_smoke.py``'s gates): centroids, rk and means
    within 1e-5 (vectors of their largest component), logdets and tau within
    1e-4, identical decisions on every training latent."""
    from anuraxla_torch.detect.gaussian_map import fit_map, map_decide
    from anuraxla_torch.detect.radial import fit_radial, radial_decide

    Z, mask = _latents()
    on = {d: (torch.from_numpy(Z).to(d), torch.from_numpy(mask).to(d)) for d in ("cuda", "cpu")}
    flat = {d: on[d][0][on[d][1]] for d in on}
    ranks = torch.arange(4, dtype=torch.float32)
    rg, rc = (fit_radial(*on[d], 0.95, 0.01) for d in ("cuda", "cpu"))
    assert _row_rel(rg.centroids.cpu().numpy(), rc.centroids.numpy()) <= 1e-5
    np.testing.assert_allclose(rg.rk.cpu().numpy(), rc.rk.numpy(), rtol=1e-5)
    dg = radial_decide(flat["cuda"], rg.centroids, rg.rk, ranks.cuda())
    dc = radial_decide(flat["cpu"], rc.centroids, rc.rk, ranks)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(dg[:2], dc[:2]))
    for kw in (dict(cov_type="lda", cov_structure="full"), dict(cov_type="qda", cov_structure="diag", shrink=0.1),
               dict(cov_type="qda", cov_structure="full", shrink=0.1, priors_mode="uniform")):
        mg, mc = (fit_map(*on[d], tau_q=0.01, **kw) for d in ("cuda", "cpu"))
        assert _row_rel(mg.means.cpu().numpy(), mc.means.numpy()) <= 1e-5, kw
        np.testing.assert_allclose(mg.logdets.cpu().numpy(), mc.logdets.numpy(), rtol=1e-4)
        np.testing.assert_allclose(float(mg.tau), float(mc.tau), rtol=1e-4)
        dg = map_decide(flat["cuda"], mg.means, mg.precisions, mg.logdets, mg.priors, mg.tau)
        dc = map_decide(flat["cpu"], mc.means, mc.precisions, mc.logdets, mc.priors, mc.tau)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(dg[:2], dc[:2])), kw


def test_quantiles_and_non_pd_repair_on_card(card):
    from anuraxla_torch.ops.linalg import inv_and_logdet
    from anuraxla_torch.ops.quantiles import masked_quantile

    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 40)).astype(np.float32)
    m = rng.random((6, 40)) > 0.3
    m[5] = False
    for q in (0.01, 0.5, [0.05, 0.95]):
        got = masked_quantile(torch.from_numpy(x).cuda(), torch.from_numpy(m).cuda(), q).cpu()
        assert torch.equal(got, masked_quantile(torch.from_numpy(x), torch.from_numpy(m), q))
    q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    mats = np.stack([q @ np.diag([1.0, 2, 3, 0.5, 0.2, ev]) @ q.T for ev in (0.1, -5e-4, -0.5)]).astype(np.float32)
    mats = (mats + mats.transpose(0, 2, 1)) / 2
    pg, lg = inv_and_logdet(torch.from_numpy(mats).cuda())
    pc, lc = inv_and_logdet(torch.from_numpy(mats))
    np.testing.assert_allclose(lg[:2].cpu().numpy(), lc[:2].numpy(), rtol=1e-4)
    np.testing.assert_allclose(pg[:2].cpu().numpy(), pc[:2].numpy(), rtol=1e-3, atol=1e-3)
    assert torch.isnan(lg[2]) and torch.isnan(lc[2])


def test_encode_paths_through_pinned_slots_on_card(card, tmp_path):
    """``encode_paths`` decodes into pinned slots and sends them as they are:
    its latents equal ``encode_array``'s (rows copied into a slot), clean,
    noised in place and over PCM16; more batches than slots, so every slot
    is written again after its transfer."""
    from anuraxla_torch.pipeline.dataset import load_wav_batch

    cfg = DEFAULT_MEL.replace(duration=1.0)
    rng = np.random.default_rng(12)
    paths = []
    for i in range(10):
        paths.append(tmp_path / f"c{i}.wav")
        write_wav(paths[-1], (0.1 * rng.standard_normal(cfg.num_samples)).astype(np.float32), cfg.sr)
    rows = load_wav_batch(paths, sr=cfg.sr, num_samples=cfg.num_samples).audio
    for kw in (dict(pre_padded_host=True), dict(pre_padded_host=True, transfer_int16=True), dict(add_noise_db=6.0)):
        s = EncoderSession(mel=cfg, batch_size=2, normalize_on_device=True, init_seed=3, project_root=tmp_path,
                           **kw).load()
        Z, ok, _ = s.encode_paths(paths)
        assert ok.all() and all(b.is_pinned() for b in s._rings[torch.float32].bufs)
        if "add_noise_db" in kw:  # the noise is seeded by each row's index in the whole list
            want = [s._dispatch(s._inject_noise(rows[i : i + 2], i, 2)).cpu().numpy() for i in range(0, 10, 2)]
        else:
            want = [s.encode_array(rows[i : i + 2]) for i in range(0, 10, 2)]
        want = np.concatenate(want)
        assert np.array_equal(Z, want), kw


@pytest.mark.parametrize("downsample", ["stride", "avgpool"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_on_card_match_cpu(card, downsample, dtype):
    """Three train steps of the conv VAE (``models.train``) on the card
    against the same steps on the CPU, from the same params, batches and
    noise, with the tolerances of tests/test_torch_train.py. f32: the step
    holds TF32 off across the backward too (loss rtol 1e-5, every gradient
    within 1e-4 of its tensor's max, all but 1 % of the parameters within
    1e-5 + 1e-4|p|: Adam moves an element whose gradient sits at rounding
    level by ~lr either way). A bf16 trunk: loss rtol 1e-2; each gradient
    within 0.2 of its tensor's max, 6e-2 where it is not a bias (the
    cancelling sums); all but 1 % of the parameters within lr/4."""
    from anuraxla_torch.models.train import TrainConfig, create_train_state, make_train_step
    from anuraxla_torch.models.vae import VAEConfig

    cfg = VAEConfig(latent_dim=8, widths=(8, 16), dense_width=32, groups=4, input_hw=(48, 32),
                    downsample=downsample, dtype=dtype)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10, beta=0.25, kl_delay_steps=1,
                     kl_warmup_steps=2)
    rng = np.random.default_rng(13)
    batches = [torch.from_numpy(rng.standard_normal((6, 48, 32, 1)).astype(np.float32)) for _ in range(3)]
    eps = [torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32)) for _ in range(3)]
    step = make_train_step(tc.beta, tc.kl_warmup_steps, tc.kl_delay_steps)
    out = {}
    for dev in ("cpu", card):
        _, st = create_train_state(cfg, tc, device=dev)
        losses = [float(step(st, b.to(dev), e.to(dev))[1]["loss"]) for b, e in zip(batches, eps)]
        grads = {k: p.grad.cpu() for k, p in st.model.named_parameters()}
        out[str(dev)] = losses, grads, {k: v.cpu() for k, v in st.model.state_dict().items()}
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out["cuda"]
    bf16 = dtype == "bfloat16"
    np.testing.assert_allclose(lg, lc, rtol=1e-2 if bf16 else 1e-5)
    for k in gc:
        tol = (0.2 if k.endswith("bias") else 6e-2) if bf16 else 1e-4
        assert float((gg[k] - gc[k]).abs().max()) <= tol * float(gc[k].abs().max()), k
    d = torch.cat([(pg[k] - pc[k]).abs().ravel() for k in pc])
    scale = torch.cat([pc[k].abs().ravel() for k in pc])
    limit = tc.learning_rate / 4 if bf16 else 1e-5 + 1e-4 * scale
    assert float((d > limit).float().mean()) <= 0.01


# the int8 serving path: csrc/int8_gemm.cu against its plain version, bitwise
INT8_CONVS = [
    # B, H, W, Cin, Cout, stride, pads: the default encoder's first conv (K = 9)
    # at B = 1 and an odd B, a stride-1 conv of block 0, TORCH pads, a ragged
    # Cout and Cin (byte gathers), and the last block's conv (K = 2304)
    (1, 192, 64, 1, 32, 2, ((0, 1), (0, 1))),
    (63, 192, 64, 1, 32, 2, ((0, 1), (0, 1))),
    (3, 96, 32, 32, 32, 1, ((1, 1), (1, 1))),
    (2, 48, 16, 64, 128, 2, ((1, 1), (1, 1))),
    (5, 7, 9, 3, 12, 2, ((0, 1), (1, 1))),
    (7, 12, 4, 256, 256, 1, ((1, 1), (1, 1))),
]


def _int8_operands(shape, seed):
    g = torch.Generator().manual_seed(seed)
    B, H, W, cin, cout = shape[:5]
    x = torch.randint(-127, 128, (B, H, W, cin), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, dtype=torch.int8)
    return x, w, torch.rand(B, generator=g) * 0.05, torch.rand(cout, generator=g) * 0.01, torch.randn(cout, generator=g)


@pytest.mark.parametrize("shape", INT8_CONVS, ids=lambda s: "x".join(map(str, s[:5])) + f"s{s[5]}")
def test_int8_conv_kernel_matches_plain(card, shape):
    from anuraxla_torch.ops import int8 as ti8

    x, w, sx, sw, bias = _int8_operands(shape, sum(shape[:5]))
    stride, pads = shape[5], shape[6]
    ref = ti8.int8_conv_plain(x, w, sx, sw, bias, stride, pads)
    raw_ref = ti8.int8_conv_plain(x, w, sx, sw, bias, stride, pads, raw=True)
    n0 = ti8.launches()
    dev = [t.to(card) for t in (x, w, sx, sw, bias)]
    got = ti8.int8_conv(*dev, stride, pads)
    raw = ti8.int8_conv(*dev, stride, pads, raw=True)
    one = ti8.int8_conv(*dev[:2], dev[2][:1], *dev[3:], stride, pads)  # one scale for every row
    torch.cuda.synchronize()
    assert ti8.launches() == dict(n0, int8_conv=n0["int8_conv"] + 3)
    assert torch.equal(got.cpu(), ref) and torch.equal(raw.cpu(), raw_ref)
    assert torch.equal(one.cpu(), ti8.int8_conv_plain(x, w, sx[:1], sw, bias, stride, pads))


@pytest.mark.parametrize("mkn", [(1, 12288, 512), (63, 12288, 512), (1024, 12288, 512), (17, 9, 5), (33, 100, 40)])
def test_int8_dense_kernel_matches_plain(card, mkn):
    from anuraxla_torch.ops import int8 as ti8

    M, K, N = mkn
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    sx, sw, bias = torch.rand(M, 1, generator=g), torch.rand(N, generator=g) * 0.01, torch.randn(N, generator=g)
    n0 = ti8.launches()["int8_dense"]
    got = ti8.int8_dense(*(t.to(card) for t in (x, w, sx, sw, bias)))
    torch.cuda.synchronize()
    assert ti8.launches()["int8_dense"] == n0 + 1
    assert torch.equal(got.cpu(), ti8.int8_dense_plain(x, w, sx, sw, bias))


def test_int8_wrappers_refuse_on_cuda(card):
    from anuraxla_torch.ops import int8 as ti8

    x, w, sx, sw, bias = (t.to(card) for t in _int8_operands(INT8_CONVS[4], 1))
    with pytest.raises(ValueError, match="int8"):  # int8 codes or f32 activations, nothing else
        ti8.int8_conv(x.double(), w, sx, sw, bias, 2, ((0, 1), (1, 1)))
    with pytest.raises(ValueError, match="stride"):
        ti8.int8_conv(x, w, sx, sw, bias, 3, ((0, 1), (1, 1)))
    with pytest.raises(ValueError, match="sw and bias"):
        ti8.int8_conv(x, w, sx, sw[:-1], bias, 2, ((0, 1), (1, 1)))
    with pytest.raises(ValueError, match="sx"):
        ti8.int8_conv(x, w, sx[:2], sw, bias, 2, ((0, 1), (1, 1)))
    with pytest.raises(ValueError, match="is on"):
        ti8.int8_conv(x, w.cpu(), sx, sw, bias, 2, ((0, 1), (1, 1)))


# the f32-operand mode (quantized as the kernel loads it) against its plain
# version, bitwise: the default encoder's layer shapes (SAME, TORCH pads,
# the avgpool family's stride-1 convs: the halo form), two convs of the
# gathered form (Cin no power of two), odd shapes on the simple path, random
# x with clamped codes and x of ties only
INT8_F32_CONVS = [
    (2, 192, 64, 1, 32, 2, ((0, 1), (0, 1))),
    (3, 96, 32, 32, 32, 1, ((1, 1), (1, 1))),
    (2, 96, 32, 32, 64, 2, ((0, 1), (0, 1))),
    (2, 96, 32, 32, 64, 2, ((1, 1), (1, 1))),
    (1, 48, 16, 64, 64, 1, ((1, 1), (1, 1))),
    (3, 48, 16, 64, 128, 2, ((0, 1), (0, 1))),
    (2, 24, 8, 128, 128, 1, ((1, 1), (1, 1))),
    (5, 24, 8, 128, 256, 2, ((0, 1), (0, 1))),
    (7, 12, 4, 256, 256, 1, ((1, 1), (1, 1))),
    (3, 48, 16, 48, 64, 1, ((1, 1), (1, 1))),
    (2, 48, 16, 96, 128, 2, ((0, 1), (0, 1))),
    (5, 7, 9, 3, 12, 2, ((0, 1), (1, 1))),
    (2, 10, 6, 16, 32, 1, ((1, 1), (1, 1))),
    (3, 13, 9, 32, 64, 2, ((1, 1), (0, 1))),
]


def _f32_operands(shape, seed, ties):
    """f32 x whose codes clamp past +-127, or x = (k + 1/2) sx exactly (sx a
    power of two): every code a tie, rounded half to even."""
    g = torch.Generator().manual_seed(seed)
    B, H, W, cin, cout = shape[:5]
    if ties:
        sx = torch.full((B,), 2.0 ** -5)
        x = (torch.randint(-140, 140, (B, H, W, cin), generator=g).float() + 0.5) * 2.0 ** -5
    else:
        sx = torch.rand(B, generator=g) * 0.05 + 1e-3
        x = torch.randn(B, H, W, cin, generator=g) * 60.0 * sx[:, None, None, None]
    w = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, dtype=torch.int8)
    return x, w, sx, torch.rand(cout, generator=g) * 0.01, torch.randn(cout, generator=g)


@pytest.mark.parametrize("ties", [False, True], ids=["clamps", "ties"])
@pytest.mark.parametrize("shape", INT8_F32_CONVS, ids=lambda s: "x".join(map(str, s[:5])) + f"s{s[5]}")
def test_int8_conv_f32_operand_matches_plain(card, shape, ties):
    from anuraxla_torch.ops import int8 as ti8

    x, w, sx, sw, bias = _f32_operands(shape, sum(shape[:5]), ties)
    stride, pads = shape[5], shape[6]
    codes = ti8.quantize_rows(x, sx)
    ref = ti8.int8_conv_plain(x, w, sx, sw, bias, stride, pads)
    raw_ref = ti8.int8_conv_plain(x, w, sx, sw, bias, stride, pads, raw=True)
    assert torch.equal(ref, ti8.int8_conv_plain(codes, w, sx, sw, bias, stride, pads))
    dev = [t.to(card) for t in (x, w, sx, sw, bias)]
    tile = ti8.wgmma_tile(9 * shape[3], shape[4])
    packed = ti8.pack_weight(dev[1]) if tile else None
    if tile:  # the halo form exactly where Cin is a power of two from 32
        assert ti8.halo_fits(*shape[:5], stride, pads, tile[1]) == (shape[3] >= 32 and shape[3] & (shape[3] - 1) == 0)
    n0 = ti8.launches()["int8_conv"]
    got = ti8.int8_conv(*dev, stride, pads, packed=packed)
    raw = ti8.int8_conv(*dev, stride, pads, raw=True, packed=packed)
    one = ti8.int8_conv(*dev[:2], dev[2][:1], *dev[3:], stride, pads, packed=packed)  # one scale for every row
    torch.cuda.synchronize()
    assert ti8.launches()["int8_conv"] == n0 + 3
    assert torch.equal(got.cpu(), ref) and torch.equal(raw.cpu(), raw_ref)
    assert torch.equal(one.cpu(), ti8.int8_conv_plain(x, w, sx[:1], sw, bias, stride, pads))


@pytest.mark.parametrize("ties", [False, True], ids=["clamps", "ties"])
@pytest.mark.parametrize("m", [1, 63, 1024])
def test_int8_dense_split_k_matches_plain(card, m, ties):
    """The dense at K = 12288 split over the card's SMs, both operand modes,
    the raw sums and the f32 epilogue; twice, so the counters the first call
    leaves serve the second."""
    from anuraxla_torch.ops import int8 as ti8

    K, N = 12288, 512
    g = torch.Generator().manual_seed(m + ties)
    if ties:
        sx = torch.full((m, 1), 2.0 ** -5)
        x = (torch.randint(-140, 140, (m, K), generator=g).float() + 0.5) * 2.0 ** -5
    else:
        sx = torch.rand(m, 1, generator=g) * 0.05 + 1e-3
        x = torch.randn(m, K, generator=g) * 60.0 * sx
    w = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    sw, bias = torch.rand(N, generator=g) * 0.01, torch.randn(N, generator=g)
    bn, bk = ti8.wgmma_tile(K, N, dense=True)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert ti8.dense_splits(-(-m // 128), N // bn, K // bk, sms) > 1  # the split path
    dev = [t.to(card) for t in (x, w, sx, sw, bias)]
    packed = ti8.pack_weight(dev[1])
    codes = ti8.quantize_rows(dev[0], dev[2])
    for xin in (dev[0], codes):
        for _ in range(2):
            got = ti8.int8_dense(xin, *dev[1:], packed=packed)
            raw = ti8.int8_dense(xin, *dev[1:], raw=True, packed=packed)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), ti8.int8_dense_plain(x, w, sx, sw, bias))
            assert torch.equal(raw.cpu(), ti8.int8_dense_plain(x, w, sx, sw, bias, raw=True))


def test_quantized_forward_fused_equals_torch_quantization(card, monkeypatch):
    """The int8 encoder on the card: activations quantized on load give the
    latents of torch's quantization + the int8-operand mode (each
    contraction's x quantized first, by a shim), bit for bit."""
    from anuraxla_torch.models import quant as tq
    from anuraxla_torch.models.quant import encoder_apply_quantized, quantize_encoder
    from anuraxla_torch.models.vae import VAEConfig, init_encoder_params
    from anuraxla_torch.ops import int8 as ti8

    cfg = VAEConfig()
    q = quantize_encoder(init_encoder_params(cfg, torch.Generator().manual_seed(0)), cfg, device=card)
    assert "wq_packed" in q["conv"]["EncoderBlock_3/Conv_1"] and "wq_packed" in q["conv"]["Dense_0"]
    x = torch.randn(9, *cfg.input_hw, 1, generator=torch.Generator().manual_seed(1)).to(card)
    with torch.inference_mode():
        fused = encoder_apply_quantized(q, cfg, x)["mu"]
        monkeypatch.setattr(tq, "int8_conv", lambda v, w, sx, *a, **k: ti8.int8_conv(
            ti8.quantize_rows(v, sx), w, sx, *a, **k))
        monkeypatch.setattr(tq, "int8_dense", lambda v, w, sx, *a, **k: ti8.int8_dense(
            ti8.quantize_rows(v, sx), w, sx, *a, **k))
        ref = encoder_apply_quantized(q, cfg, x)["mu"]
    assert torch.equal(fused, ref)


def test_quantized_session_on_card_matches_cpu(card):
    """quantize=True at DEFAULT_MEL, default VAEConfig, parity tier: the card's
    latents against the same session on the CPU within the free-running bound
    of tests/test_torch_quant.py (the integer parts are bitwise; GroupNorm's f32
    sums differ in their last bits and can flip a code), a row alone equal
    to the same row beside loud batch-mates (atol 1e-5), and the kernels'
    counters move."""
    from anuraxla_torch.ops import int8 as ti8

    y = _rows(DEFAULT_MEL, 5, seed=21)
    z = {}
    for dev in ("cpu", card):
        s = EncoderSession(mel=DEFAULT_MEL, device=dev, batch_size=8, init_seed=3, quantize=True).load()
        n0 = ti8.launches()
        z[str(dev)] = s.encode_array(y)
    assert ti8.launches()["int8_conv"] == n0["int8_conv"] + 8 and ti8.launches()["int8_dense"] == n0["int8_dense"] + 1
    zc, zg = z["cpu"], z["cuda"]
    live = np.linalg.norm(zc, axis=-1) > 0  # a row that standardizes to a zero mel gives mu = 0 on both
    assert np.array_equal(live, np.linalg.norm(zg, axis=-1) > 0) and live.sum() >= 4
    zc, zg = zc[live], zg[live]
    rel = np.abs(zg - zc).max(-1) / np.abs(zc).max(-1)
    cos = (zg * zc).sum(-1) / (np.linalg.norm(zg, axis=-1) * np.linalg.norm(zc, axis=-1))
    assert rel.max() <= 0.1 and cos.min() >= 0.997
    loud = np.clip(20.0 * _rows(DEFAULT_MEL, 3, seed=22), -1, 1)
    alone = s.encode_array(y[2:3])
    mixed = s.encode_array(np.concatenate([y[2:3], loud]))
    np.testing.assert_allclose(mixed[0], alone[0], atol=1e-5, rtol=0)


def test_parallel_path_on_card_matches_single(card):
    """The parallel slice over 4 data shards that repeat the card: the
    data-parallel session (pinned slots sent a shard slice at a time) against
    the single session (parity f32: rtol 5e-4 / atol 2e-5; the mel kernel
    launched once a shard), the sharded fits and sharded_quantile against the
    single-device ones on the card, and two sharded train steps over 2 data
    x 2 model shards against the unsharded steps, as the JAX suite sets them
    (lr 0 at the warm-up step, then 1e-3): the loss and the gradients,
    through AdamW's first moment, at each step, then the parameters."""
    from anuraxla_torch.detect.gaussian_map import fit_map
    from anuraxla_torch.detect.radial import fit_radial
    from anuraxla_torch.models.train import TrainConfig, create_train_state, make_train_step
    from anuraxla_torch.models.vae import VAEConfig
    from anuraxla_torch.ops.quantiles import masked_quantile
    from anuraxla_torch.parallel import mesh as pmesh
    from anuraxla_torch.parallel.fit import fit_map_sharded, fit_radial_sharded, sharded_quantile
    from anuraxla_torch.parallel.train_sharded import make_sharded_train_step, shard_state

    cfg = DEFAULT_MEL.replace(duration=1.0)
    y = _rows(cfg, 10, seed=31)
    kw = dict(mel=cfg, device=card, init_seed=3, normalize_on_device=True, pre_padded_host=True)
    pmesh.set_default_devices(["cuda:0"] * 4)
    try:
        s1 = EncoderSession(**kw, batch_size=8).load()
        s4 = EncoderSession(**kw, batch_size=6, data_parallel=True).load()
        assert s4.batch_size == 8 and s4._mesh.shape == {"data": 4, "model": 1}
        n0 = _launches()["mel_power_ct"]
        z4 = s4.encode_array(y)  # 10 rows: padded to 12
        assert _launches()["mel_power_ct"] == n0 + 4
        np.testing.assert_allclose(z4, s1.encode_array(y), rtol=5e-4, atol=2e-5)
        mesh = pmesh.make_mesh(device="cuda")
    finally:
        pmesh.set_default_devices(None)

    rng = np.random.default_rng(4)
    Z = (rng.standard_normal((3, 41, 16)) + 3 * np.arange(3)[:, None, None]).astype(np.float32)
    mask = np.ones((3, 41), bool)
    mask[1, 30:] = False
    Zc, mc = torch.from_numpy(Z).to(card), torch.from_numpy(mask).to(card)
    a, b = fit_radial(Zc, mc, 0.9, 0.2), fit_radial_sharded(Z, mask, 0.9, 0.2, mesh=mesh)
    for name in ("centroids", "rk", "rk_in", "rk_out"):
        torch.testing.assert_close(getattr(b, name), getattr(a, name), rtol=1e-5, atol=1e-6)
    kw = dict(cov_type="qda", cov_structure="diag", shrink=0.1, tau_q=0.05)
    a, b = fit_map(Zc, mc, **kw), fit_map_sharded(Z, mask, mesh=mesh, **kw)
    for name in ("means", "logdets", "tau"):
        torch.testing.assert_close(getattr(b, name), getattr(a, name), rtol=2e-4, atol=2e-5)
    d = torch.rand((2, 5000), device=card, generator=torch.Generator(device=card).manual_seed(0))
    m = d > 0.05
    torch.testing.assert_close(sharded_quantile(d, m, 0.37, mesh=mesh), masked_quantile(d, m, 0.37),
                               rtol=3e-7, atol=0.0)

    vcfg = VAEConfig(latent_dim=16, widths=(8, 128), dense_width=256, groups=4, input_hw=(16, 16))
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, beta=0.1, kl_delay_steps=0, kl_warmup_steps=0)
    x = torch.from_numpy(rng.standard_normal((8, 16, 16, 1)).astype(np.float32)).to(card)
    _, plain = create_train_state(vcfg, tc, device=card)
    _, state = create_train_state(vcfg, tc, device=card)
    mesh = pmesh.make_mesh(devices=["cuda:0"] * 4, model_axis=2)
    ss, _ = shard_state(state, mesh)
    plain_step, sharded_step = make_train_step(tc.beta), make_sharded_train_step(tc.beta, mesh)
    pa, pb = dict(plain.model.named_parameters()), dict(ss.state.model.named_parameters())
    for step in range(2):  # the second step's gradients come from the refreshed replicas
        eps = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)).to(card)
        plain, pm = plain_step(plain, x, eps)
        ss, sm = sharded_step(ss, x, eps)
        torch.testing.assert_close(sm["loss"], pm["loss"], rtol=1e-4, atol=0.0)
        for k in pa:
            ma, mb = plain.optimizer.state[pa[k]]["exp_avg"], ss.state.optimizer.state[pb[k]]["exp_avg"]
            assert float((mb - ma).abs().max()) <= 1e-4 * float(ma.abs().max()), (step, k)
    for (name, p), q in zip(plain.model.state_dict().items(), ss.state.model.state_dict().values()):
        torch.testing.assert_close(q, p, rtol=2e-3, atol=2e-4, msg=name)


@pytest.mark.parametrize("layout", ["rows", "pre_padded", "odd_row"])
@pytest.mark.parametrize("n_valid", [1024, 777])
def test_window_expand_kernel_matches_plain(card, layout, n_valid):
    """The kernel at the scan's batch (B 1 024 x 240 000, 5 s windows at a
    2.5 s hop) equals its plain version bit for bit: two files, each with a
    last window past its EOF, rows past ``n_valid`` zero; the pre-padded
    layout, and a row length that is no multiple of 4 (scalar stores)."""
    B, L = 1024, DEFAULT_MEL.num_samples
    hop = L // 2
    row_len, col = {"rows": (L, 0), "pre_padded": tk.phase_padded_layout(DEFAULT_MEL, DEFAULT_MEL.total_frames),
                    "odd_row": (L + 3, 1)}[layout]
    first = n_valid // 2
    n1, n2 = (first - 1) * hop + L // 3, (n_valid - first - 1) * hop + L - 1000
    rng = np.random.default_rng(13)
    runs = rng.integers(-32768, 32768, n1 + n2, dtype=np.int16)
    runs[:2] = (-32768, 32767)
    table = np.zeros((B, 2), np.int32)
    for j in range(n_valid):
        base, end = (0, n1) if j < first else (n1, n1 + n2)
        off = base + (j if j < first else j - first) * hop
        table[j] = (off, min(off + L, end) - off)
    slot = torch.from_numpy(np.concatenate([table.view(np.int16).ravel(), runs])).to(card)
    n0 = window_expand.launches
    got = window_expand(slot, B, L, row_len, col)
    assert window_expand.launches == n0 + 1
    want = window_expand_plain(slot, B, L, row_len, col)
    torch.cuda.synchronize()
    assert got.shape == (B, row_len) and torch.equal(got, want)
    assert not got[n_valid:].any() and not got[:, :col].any()
    assert torch.equal(got[0, col : col + L].cpu(), torch.from_numpy(runs[:L].astype(np.float32) / 32768))
    assert int(table[first - 1, 1]) == L // 3 and not got[first - 1, col + L // 3 :].any()


def test_window_spans_through_the_session_on_card(card, tmp_path):
    """The scan's span route on the card: ``fleet_span_batches`` into the
    session's pinned int16 ring, expanded by one kernel launch a batch, gives
    the latents of the host route's rows (``fleet_window_batches``) bit for
    bit; with the pre-padded layout and on the int16 link too; more batches
    than slots, so every slot is written again after its transfer."""
    from anuraxla_torch.pipeline.stream import fleet_span_batches, fleet_window_batches
    from anuraxla_torch.utils.wavio import WavStream

    cfg = DEFAULT_MEL.replace(duration=1.0)
    rng = np.random.default_rng(14)
    paths = []
    for i, sec in enumerate((3.3, 2.1, 4.0)):
        paths.append(tmp_path / f"r{i}.wav")
        write_wav(paths[-1], (0.1 * rng.standard_normal(int(cfg.sr * sec))).astype(np.float32), cfg.sr)
    hop = cfg.sr // 2
    for kw in (dict(), dict(pre_padded_host=True), dict(transfer_int16=True)):
        s = EncoderSession(mel=cfg, batch_size=4, normalize_on_device=True, init_seed=3, project_root=tmp_path,
                           **kw).load()
        args = dict(num_samples=cfg.num_samples, hop_samples=hop, batch_size=4)
        n0, n = window_expand.launches, 0
        spans = fleet_span_batches([WavStream(p) for p in paths], ring=s.span_ring(), **args)
        rows = fleet_window_batches([WavStream(p) for p in paths], target_sr=cfg.sr, layout=s._layout, **args)
        for (sp, tags, nv), (r, rtags, rnv) in zip(spans, rows):
            z = s._dispatch(sp).cpu().numpy()
            assert np.array_equal(tags, rtags) and nv == rnv
            assert np.array_equal(z, s._dispatch(r).cpu().numpy()), (kw, n)
            n += 1
        assert n == 5 and window_expand.launches == n0 + n
        assert all(b.is_pinned() for b in s._span_ring.bufs)
