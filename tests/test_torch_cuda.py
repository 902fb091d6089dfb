"""The port's Hopper kernels and their wrapper on the card: each kernel and
mode against its plain PyTorch version (exact: 2e-5 of each row's max, the
exact tier's bound; bf16: 3e-3 for the largest difference — a flipped bf16
rounding of a dominant power value, as chip_smoke.py shows against f64 sums —
and 2e-5 for the mean), launch counting
by kernel and mode, the wrapper's refusals on a CUDA tensor, and the sessions
on the card against the same sessions on the CPU.

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
    """``fused_dots=True`` on the card (the split kernel on the tensor cores)
    against its plain version, and the exact mode against plain f32 too."""
    cfg = MelConfig(**cfg)
    total = cfg.total_frames
    first, T = (max(0, (total - cfg.target_frames) // 2), min(cfg.target_frames, total)) if fast else (0, total)
    y = _rows(cfg, 4, seed=7)
    raw = torch.from_numpy(y).to(card)
    s = tfe.rms_scale_batch(raw)
    pad = cfg.n_fft // 2
    x, centred = raw, torch.nn.functional.pad(raw, (pad, pad))
    if pre_padded:
        L_pad, off = tk.phase_padded_layout(cfg, T)
        x = centred = torch.nn.functional.pad(raw, (off, L_pad - off - cfg.num_samples))
    counter = "mel_power_ct_fused" if exact else "mel_power_ct_fused_bf16"
    n0 = _launches()
    got = tk.mel_power(x, cfg, num_frames=T, first_frame=first, rms_scale=s, pre_padded=pre_padded,
                       exact=exact, fused_dots=True)
    assert _launches() == dict(n0, **{counter: n0[counter] + 1})
    ref = tk.mel_power_ct_fused_plain(centred, s, cfg, T, first_frame=first, exact=exact)
    assert got.shape == ref.shape == (4, T, cfg.n_mels) and torch.isfinite(got).all()
    rel = (got - ref).abs() / ref.abs().amax(dim=(1, 2), keepdim=True)
    assert float(rel.max()) <= (2e-5 if exact else 3e-3), rel.amax(dim=(1, 2))
    assert float(rel.mean()) <= 2e-5
    if exact:  # the split scheme holds the exact tier's gate against plain f32
        f32 = tk.mel_power_ct_plain(centred, s, cfg, T, first_frame=first)
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
