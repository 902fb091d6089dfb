"""The port's kernel-study path held against the JAX package on the CPU: the
concatenated-operand tables (``fused_dots=True``) bitwise, the fused plain
version against the Pallas kernel in interpret mode on both of its
assemblies, ``ablate=`` class by class, and every refusal. Inputs come from
numpy seeds and go to both packages.

Tolerances, per row against the row's max |reference|. Exact: 2e-5 (the same
bf16 products, f32 sums in another order; test_pallas_frontend.py:33). bf16:
both sides round the same values at the same points, but their inner stages
sum in another order (radix 4x4 against literal weights) and an f32 value
that differs in its last bit can round to the other bf16 neighbour, 2^-8
relative away; one flipped value of a dominant bin moves a mel band by about
that share of the row's max. On these rows the largest difference reads up to
1.1e-3 and the mean 3e-7, so the largest is held to 3e-3 and the mean to 2e-5
(the gates the card run holds the bf16 kernels to): a misplaced rounding point
would move every value by ~1e-3. Against the non-fused versions the gates are
the JAX suite's own (test_pallas_frontend.py:351: 1e-5 exact, 5e-3 bf16, of
the batch's max); per row the exact split scheme is held to 2e-5 of plain f32
(it reads up to 1.1e-5, as the reference's own split kernel does)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anuraxla.constants import MelConfig as JMel
from anuraxla.ops import pallas_frontend as jpf
from anuraxla_torch.constants import MelConfig
from anuraxla_torch.ops import mel_kernel as tk

R16 = dict(sr=48000, duration=1.0, n_mels=64, fmin=150.0, fmax=15000.0,
           hop_length=384, n_fft=2048, target_frames=96)
SMALL = dict(sr=16000, duration=0.5, n_mels=32, fmin=100.0, fmax=7500.0,
             hop_length=128, n_fft=256, target_frames=48)
TOL = {True: 2e-5, False: 3e-3}  # largest difference; the mean is held to 2e-5


def _rows(cfg, B, seed):
    """[B, num_samples] rows and their scales: row 0 carries the silence
    sentinel (s = -1, raw passthrough), row 1 clips after scaling."""
    rng = np.random.default_rng(seed)
    y = (0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)
    scale = (0.5 + np.abs(rng.standard_normal(B))).astype(np.float32)
    scale[0] = -1.0
    scale[1] = 12.0
    return y, scale


def _row_rel(got, ref):
    """Largest |got - ref| of each row's max |ref|; the mean must be <= 2e-5."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    rel = np.abs(got - ref) / np.abs(ref).max(axis=(1, 2), keepdims=True)
    assert rel.mean() <= 2e-5, rel.mean()
    return rel.max()


def _centre(y, cfg):
    return torch.nn.functional.pad(torch.from_numpy(y), (cfg.n_fft // 2, cfg.n_fft // 2))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "bf16"])
@pytest.mark.parametrize("n_fft", [2048, 1024, 256])
def test_cat_tables_bitwise(n_fft, exact):
    """win, rhs_real, rhs_cplx and fbcat equal the reference's value for
    value; for R = 2 the reference pads rhs_cplx with a dummy block that is
    never read, the port keeps it empty."""
    args = (48000, n_fft, 64, 150.0, 15000.0, exact)
    jwin, *jtabs = jpf._ct_tables_folded_cat(*args)
    win, *tabs = tk.ct_tables_folded_cat(*args)
    np.testing.assert_array_equal(win, jwin.reshape(-1))
    K1 = 384 if exact else 128
    R = n_fft // 128
    n_real = 2 if R % 2 == 0 else 1
    shapes = [(n_real * K1, 256), ((R // 2 + 1 - n_real) * 2 * K1, 256), ((R // 2 + 1) * K1, 64)]
    for i, (got, want, shape) in enumerate(zip(tabs, jtabs, shapes)):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
        want = np.asarray(want, np.float32)
        if n_fft == 256 and i == 1:
            assert got.shape[0] == 0 and not want.any()
            continue
        np.testing.assert_array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))


def _read_stage(stage: np.ndarray, rows: int, steps: int, part: int) -> np.ndarray:
    """bf16 bits [rows, 16·steps] of one part of a stream stage, read as the
    kernel's wgmma descriptors address it: 8-row x 16-byte core matrices 128 B
    apart along K and 256 B apart along M, k16 steps rows·32 B apart, parts
    one after another."""
    m = np.arange(rows)[:, None]
    k = np.arange(16 * steps)[None, :]
    off = (part * steps * rows * 32 + (k // 16) * rows * 32 + ((m // 8) * 2 + (k % 16) // 8) * 128
           + (m % 8) * 16 + (k % 8) * 2)
    return stage.view(np.uint16)[off // 2]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "bf16"])
@pytest.mark.parametrize("n_fft,n_mels", [(2048, 64), (384, 20), (256, 32)])
def test_fragment_tables_hold_the_cat_tables(n_fft, n_mels, exact):
    """The split kernel's table stream (``ct_fused_tables``), read back as its
    wgmma descriptors read it, stage by stage in the order it consumes them,
    is the cat tables' distinct blocks: T_hi and T_lo (exact) of each
    component of each r, the columns in the kernel's M order, then F_hi and
    F_lo, the mels zero-padded to 64. The third row block of each r, which
    the stream leaves out, is bitwise the first: the fact the design rests
    on."""
    args = (48000, n_fft, n_mels, 150.0, 15000.0, exact)
    _, rhs_real, rhs_cplx, fbcat = tk.ct_tables_folded_cat(*args)
    stream = tk.ct_fused_tables(*args).contiguous().view(torch.int16).numpy()
    R, K1, parts = n_fft // 128, 384 if exact else 128, 2 if exact else 1
    bits = lambda t: t.contiguous().view(torch.int16).numpy().view(np.uint16)  # noqa: E731
    blocks, i_real, i_cplx = {}, 0, 0
    for r in range(R // 2 + 1):
        if r == 0 or 2 * r == R:
            blocks[r] = bits(rhs_real[i_real * K1 : (i_real + 1) * K1])
            i_real += 1
        else:
            blocks[r] = bits(rhs_cplx[i_cplx * 2 * K1 : (i_cplx + 1) * 2 * K1])
            i_cplx += 1
    fb = bits(fbcat)
    cols = tk.fused_outer_columns().numpy()
    rows_fb = 64 * -(-n_mels // 64)
    size = tk.fused_stage_values(exact)
    k_outer, k_fb = (16 if exact else 64), min(128, size // (parts * rows_fb))
    assert stream.shape == (tk.ct_fused_n_stages(n_fft, n_mels, exact), size)
    i = 0
    for r in tk.fused_r_order(R):
        for comp in range(blocks[r].shape[0] // K1):
            seg = blocks[r][comp * K1 : (comp + 1) * K1]
            if exact:
                np.testing.assert_array_equal(seg[256:384], seg[0:128])  # (T_hi; T_lo; T_hi)
            for k in range(0, 128, k_outer):
                for part in range(parts):
                    got = _read_stage(stream[i], 256, k_outer // 16, part)
                    np.testing.assert_array_equal(got, seg[part * 128 + k : part * 128 + k + k_outer][:, cols].T)
                i += 1
        fseg = fb[r * K1 : (r + 1) * K1]
        if exact:
            np.testing.assert_array_equal(fseg[256:384], fseg[0:128])  # (F_hi; F_lo; F_hi)
        for k in range(0, 128, k_fb):
            for part in range(parts):
                got = _read_stage(stream[i], rows_fb, k_fb // 16, part)
                np.testing.assert_array_equal(got[:n_mels], fseg[part * 128 + k : part * 128 + k + k_fb].T)
                assert not got[n_mels:].any()
            assert not stream[i][parts * rows_fb * k_fb :].any()  # a stage's zero padding
            i += 1
    assert i == stream.shape[0]
    # every bin's x_re and x_im sit 8 rows apart in the same warp's 16 rows
    q, h = cols % 128, cols // 128
    assert sorted(q[h == 0]) == list(range(128)) and np.array_equal(q[h == 0], q[h == 1])
    assert np.array_equal(np.arange(256)[h == 1] - np.arange(256)[h == 0], np.full(128, 8))


def _stream_emulation(cfg, y, scale, T, exact):
    """The split kernel's arithmetic in f64 from its table stream, consumed
    stage by stage as the kernel consumes it (the stream's r order, each
    stage's parts and k16 steps at the descriptors' addresses, the power's
    bins from the M rows of x_re and x_im)."""
    R = cfg.n_fft // 128
    stream = tk.ct_fused_tables(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, exact)
    stream = stream.contiguous().view(torch.int16).numpy()
    parts = 2 if exact else 1
    rows_fb = 64 * -(-cfg.n_mels // 64)
    k_outer, k_fb = (16 if exact else 64), min(128, tk.fused_stage_values(exact) // (parts * rows_fb))
    f64 = lambda bits: bits.astype(np.uint32).__lshift__(16).view(np.float32).astype(np.float64)  # noqa: E731
    win = torch.from_numpy(tk.ct_tables_folded_cat(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, exact)[0])
    blocks = tk._ct_blocks(_centre(y, cfg), torch.from_numpy(scale), cfg, T, 0, win.double())
    cols = tk.fused_outer_columns().numpy()
    h = cols // 128
    i, mel = 0, 0.0
    for r in tk.fused_r_order(R):
        x = 0.0
        for a in (a for a in tk._inner_stage(blocks, R, r) if a is not None):
            hi, lo = (t.numpy() for t in tk._split_bf16(a))
            for k in range(0, 128, k_outer):
                ks = slice(k, k + k_outer)
                mats = [f64(_read_stage(stream[i], 256, k_outer // 16, part)) for part in range(parts)]
                x = x + hi[..., ks] @ mats[0].T
                if exact:
                    x = x + hi[..., ks] @ mats[1].T + lo[..., ks] @ mats[0].T
                i += 1
        xr, xi = np.zeros(x.shape[:-1] + (128,)), np.zeros(x.shape[:-1] + (128,))
        xr[..., cols[h == 0]] = x[..., h == 0]
        xi[..., cols[h == 1] - 128] = x[..., h == 1]
        p_hi, p_lo = (t.numpy() for t in tk._split_bf16(torch.from_numpy(xr * xr + xi * xi)))
        for k in range(0, 128, k_fb):
            ks = slice(k, k + k_fb)
            mats = [f64(_read_stage(stream[i], rows_fb, k_fb // 16, part)) for part in range(parts)]
            mel = mel + p_hi[..., ks] @ mats[0].T
            if exact:
                mel = mel + p_hi[..., ks] @ mats[1].T + p_lo[..., ks] @ mats[0].T
            i += 1
    assert i == stream.shape[0]
    return mel[..., : cfg.n_mels]


# one config for each stage layout: R = 16 (the inner stage's groups), another
# R (one r at a time; odd R, a ragged mel tile), two mel tiles
STREAM_CONFIGS = {"r16": dict(R16, duration=0.3), "n_fft384": dict(SMALL, n_fft=384, n_mels=20),
                  "mels128": dict(R16, duration=0.3, n_mels=128)}


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "bf16"])
@pytest.mark.parametrize("name", list(STREAM_CONFIGS))
def test_stream_consumed_as_the_kernel_does_is_the_fused_function(name, exact):
    """The table stream, consumed as the split kernel consumes it, gives the
    fused plain version's function: f64 sums on both sides, so the two differ
    only where an f64 power lands on the other side of a bf16 rounding point
    of its split (2e-7 of a row's max at most; a misplaced column, part, step
    or stage moves values by O(1))."""
    cfg = MelConfig(**STREAM_CONFIGS[name])
    y, scale = _rows(cfg, 2, seed=28)
    T = cfg.total_frames
    got = _stream_emulation(cfg, y, scale, T, exact)
    want = tk.mel_power_ct_fused_plain(_centre(y, cfg), torch.from_numpy(scale), cfg, T, exact=exact,
                                       sums=torch.float64).numpy()
    rel = np.abs(got - want) / np.abs(want).max(axis=(1, 2), keepdims=True)
    assert rel.max() <= 2e-7, rel.max()


# every config the fused tests, the probes and chip_smoke.py's study cases take
FUSED_CONFIGS = {
    "r16": R16, "r16_2s": dict(R16, duration=2.0), "hop320": dict(R16, hop_length=320), "hop160": dict(R16, hop_length=160),
    "r8_hop512": dict(R16, hop_length=512, n_fft=1024), "n_fft256": SMALL, "n_fft384": dict(SMALL, n_fft=384, n_mels=20),
    "mels128": dict(R16, n_mels=128),
}


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "bf16"])
@pytest.mark.parametrize("name", list(FUSED_CONFIGS))
def test_fused_shared_memory_and_tile(name, exact):
    """The host's copy of the split kernel's shared memory, recounted here
    part by part, and its tile: 32 frames and the deepest ring of stages (16
    KB exact, 32 KB bf16) that fits a block; a hop whose window cannot fit is
    refused."""
    cfg = MelConfig(**FUSED_CONFIGS[name])
    parts = 2 if exact else 1
    n_aud = 31 * cfg.hop_length + cfg.n_fft
    for stages in tk.FUSED_RING:
        ring, bars, window = stages * (16384 if exact else 32768), 8 * 8, 4 * (-(-n_aud // 4) * 4)
        planes = (4 * parts + parts) * 8 * 1184  # the group's planes and the power, hi (and lo): k16 steps 1184 B apart
        assert tk.ct_fused_smem_bytes(cfg.n_fft, cfg.hop_length, stages, exact) == ring + bars + window + planes
    tile = tk.ct_fused_tile(cfg.n_fft, cfg.hop_length, exact)
    assert tile is not None and tile[0] == 32 == tk.FUSED_TF
    fits = [s for s in tk.FUSED_RING if tk.ct_fused_smem_bytes(cfg.n_fft, cfg.hop_length, s, exact) <= tk.SMEM_LIMIT]
    assert tile[1] == max(fits) and tile[1] >= 2
    assert tk.ct_fused_tile(cfg.n_fft, 4096, exact) is None  # mel_power refuses it (test_torch_cuda.py)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "bf16"])
@pytest.mark.parametrize("assembly", ["phase", "auto"])
def test_fused_plain_matches_jax(assembly, exact):
    """The fused plain version against ``fused_dots=True`` in interpret mode
    on the phase kernel and on the stack kernel (where ``auto`` routes a fused
    call), with the fused RMS scale; and against the port's non-fused plain
    version at the JAX suite's own gates."""
    cfg, jcfg = MelConfig(**R16), JMel(**R16)
    y, scale = _rows(cfg, 3, seed=21)
    T = cfg.total_frames
    want = jpf.mel_power_pallas(jnp.asarray(y), jcfg, num_frames=T, interpret=True, algorithm="ct",
                                fused_dots=True, exact=exact, assembly=assembly, rms_scale=jnp.asarray(scale))
    s = torch.from_numpy(scale)
    got = tk.mel_power_ct_fused_plain(_centre(y, cfg), s, cfg, T, exact=exact)
    assert got.shape == (3, T, cfg.n_mels)
    assert _row_rel(got, want) <= TOL[exact]
    plain = tk.mel_power_ct_plain(_centre(y, cfg), s, cfg, T, exact=exact)
    assert _row_rel(got, plain) < (2e-5 if exact else 5e-3)
    assert float((got - plain).abs().max() / plain.abs().max()) < (1e-5 if exact else 5e-3)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "bf16"])
def test_fused_plain_pre_padded_frame_range(exact):
    """Pre-padded rows and a frame range (``first_frame > 0``): the reference
    computes the whole layout's frames, the port the range alone."""
    cfg, jcfg = MelConfig(**R16), JMel(**R16)
    y, scale = _rows(cfg, 2, seed=22)
    first, T = 20, 70
    L_pad, off = tk.phase_padded_layout(cfg, first + T)
    rows = np.zeros((2, L_pad), np.float32)
    n = min(cfg.num_samples, L_pad - off)
    rows[:, off : off + n] = y[:, :n]
    want = jpf.mel_power_pallas(jnp.asarray(rows), jcfg, num_frames=first + T, interpret=True, algorithm="ct",
                                fused_dots=True, exact=exact, assembly="phase", pre_padded=True,
                                rms_scale=jnp.asarray(scale))
    got = tk.mel_power(torch.from_numpy(rows), cfg, num_frames=T, first_frame=first, pre_padded=True,
                       rms_scale=torch.from_numpy(scale), exact=exact, fused_dots=True)
    assert got.shape == (2, T, cfg.n_mels)
    assert _row_rel(got, np.asarray(want)[:, first:]) <= TOL[exact]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "bf16"])
@pytest.mark.parametrize("cfg", [dict(R16, hop_length=320, duration=0.5), SMALL], ids=["hop320", "n_fft256"])
def test_fused_plain_other_configs(cfg, exact):
    """hop % 32 (the stack kernel's family) and R = 2, where no r is complex."""
    cfg, jcfg = MelConfig(**cfg), JMel(**cfg)
    y, scale = _rows(cfg, 2, seed=23)
    T = cfg.total_frames
    want = jpf.mel_power_pallas(jnp.asarray(y), jcfg, num_frames=T, interpret=True, algorithm="ct",
                                fused_dots=True, exact=exact, rms_scale=jnp.asarray(scale))
    got = tk.mel_power(torch.from_numpy(y), cfg, num_frames=T, rms_scale=torch.from_numpy(scale),
                       exact=exact, fused_dots=True)
    assert _row_rel(got, want) <= TOL[exact]


ABLATED = [(cls, exact) for exact in (True, False) for cls in tk.ABLATE_CLASSES
           if exact or cls not in tk.EXACT_ONLY_CLASSES]


@pytest.mark.parametrize("cls,exact", ABLATED, ids=[f"{c}-{'exact' if e else 'bf16'}" for c, e in ABLATED])
def test_ablated_plain_matches_jax(cls, exact):
    """Each wired class drops what the reference's ``ablate=(cls,)`` drops;
    'splits' and 'dots' in the exact mode alone (the CPU computes an ablated
    exact call with the split arithmetic, ``mel_power_ct_split_plain``).
    'dots' leaves one bf16 pass, whose rounding points flip as the bf16
    mode's do: it is held to the bf16 gate, and it moves the output by about
    the bf16 mode's own distance from the exact one (~2e-3 of the max), not
    1e-2. 'splits' (lo = -hi) turns every product into a difference of two
    terms ~2^8 larger than itself, twice, so the order of the f32 sums shows
    ~2^16 larger: held to the bf16 gate as well (read: 7.4e-4 worst, 1.1e-7
    mean)."""
    cfg, jcfg = MelConfig(**R16), JMel(**R16)
    y, scale = _rows(cfg, 2, seed=24)
    T = cfg.total_frames
    want = jpf.mel_power_pallas(jnp.asarray(y), jcfg, num_frames=T, interpret=True, algorithm="ct",
                                exact=exact, rms_scale=jnp.asarray(scale), ablate=(cls,))
    s = torch.from_numpy(scale)
    got = tk.mel_power(torch.from_numpy(y), cfg, num_frames=T, rms_scale=s, exact=exact, ablate=(cls,))
    assert _row_rel(got, want) <= TOL[exact and cls not in tk.EXACT_ONLY_CLASSES]
    intact = tk.mel_power(torch.from_numpy(y), cfg, num_frames=T, rms_scale=s, exact=exact)
    dropped = 5e-4 if cls == "dots" else 1e-2
    assert float((got - intact).abs().max() / intact.abs().max()) > dropped  # dropped, not ignored


def test_ablate_floor_and_generic_inner_match_jax():
    """All four classes at once (the probe's floor), and the literal-weight
    inner stage of R != 16."""
    for kw, classes in ((R16, tk.ABLATE_CLASSES), (dict(SMALL, n_fft=512), ("inner",))):
        cfg, jcfg = MelConfig(**kw), JMel(**kw)
        y, scale = _rows(cfg, 2, seed=25)
        T = cfg.total_frames
        want = jpf.mel_power_pallas(jnp.asarray(y), jcfg, num_frames=T, interpret=True, algorithm="ct",
                                    rms_scale=jnp.asarray(scale), ablate=classes)
        got = tk.mel_power(torch.from_numpy(y), cfg, num_frames=T, rms_scale=torch.from_numpy(scale),
                           ablate=classes)
        assert _row_rel(got, want) <= 2e-5


def test_ablate_empty_is_bitwise_the_plain_path():
    cfg = MelConfig(**R16)
    y, scale = _rows(cfg, 2, seed=26)
    s = torch.from_numpy(scale)
    for exact in (True, False):
        a = tk.mel_power(torch.from_numpy(y), cfg, num_frames=40, first_frame=3, rms_scale=s, exact=exact)
        b = tk.mel_power(torch.from_numpy(y), cfg, num_frames=40, first_frame=3, rms_scale=s, exact=exact, ablate=())
        c = tk.mel_power_ct_plain(_centre(y, cfg), s, cfg, 40, first_frame=3, exact=exact)
        assert torch.equal(a, b) and torch.equal(a, c)


REFUSALS = [
    # (config, mel_power keywords, a word of the reason)
    (R16, dict(ablate=("splits",), exact=False), "no split/multi-pass"),
    (R16, dict(ablate=("dots",), exact=False), "no split/multi-pass"),
    (R16, dict(ablate=("shifts",)), "any sample offset"),
    (R16, dict(ablate=("power",), fused_dots=True), "fused-dots"),
    (R16, dict(ablate=("twiddles",)), "unknown ablate class"),
    (dict(R16, hop_length=320), dict(ablate=("power",)), "hop % 128"),
    (R16, dict(ablate=("fb",), algorithm="dense"), "hop % 128"),
    (R16, dict(fused_dots=True, algorithm="dense"), "algorithm 'ct'"),
    (dict(R16, hop_length=240), dict(fused_dots=True), "algorithm 'ct'"),
]


@pytest.mark.parametrize("cfg,kw,reason", REFUSALS, ids=[f"{i}-{r[2].split()[0]}" for i, r in enumerate(REFUSALS)])
def test_refusals(cfg, kw, reason):
    """A class that is not wired raises: a silent no-op would fake profiling
    evidence (test_pallas_frontend.py:391-406)."""
    cfg = MelConfig(**cfg)
    with pytest.raises(ValueError, match=reason):
        tk.mel_power(torch.zeros((1, cfg.num_samples)), cfg, num_frames=4, **kw)
    if "ablate" in kw and not kw.get("fused_dots") and cfg.hop_length % 128 == 0 and "algorithm" not in kw:
        with pytest.raises(ValueError, match=reason):
            tk.mel_power_ct_plain(torch.zeros((1, cfg.num_samples)), None, cfg, 4,
                                  exact=kw.get("exact", True), ablate=kw["ablate"])


def test_cpu_tensor_routes_to_the_fused_plain_version():
    cfg = MelConfig(**SMALL)
    y, scale = _rows(cfg, 2, seed=27)
    T = cfg.total_frames
    before = dict(tk.mel_power.launches)
    assert set(before) == set(tk.KERNEL_NAMES) and {"mel_power_ct_fused", "mel_power_ct_fused_bf16"} <= set(before)
    for exact in (True, False):
        got = tk.mel_power(torch.from_numpy(y), cfg, num_frames=T, rms_scale=torch.from_numpy(scale),
                           exact=exact, fused_dots=True)
        want = tk.mel_power_ct_fused_plain(_centre(y, cfg), torch.from_numpy(scale), cfg, T, exact=exact)
        assert torch.equal(got, want)
        assert tk.kernel_name(cfg, "ct", exact, fused_dots=True) == ("mel_power_ct_fused" if exact else "mel_power_ct_fused_bf16")
    assert tk.mel_power.launches == before  # no launch on the CPU
