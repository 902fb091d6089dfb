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


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "bf16"])
@pytest.mark.parametrize("n_fft,n_mels", [(2048, 64), (384, 20), (256, 32)])
def test_fragment_tables_hold_the_cat_tables(n_fft, n_mels, exact):
    """The split kernel's tables, read back as ``mma.sync.m16n8k16`` reads a B
    fragment (lane 4g + c: column g, rows 2c, 2c+1 in word 0 and 2c+8, 2c+9
    in word 1), are the cat tables' blocks in r order."""
    args = (48000, n_fft, n_mels, 150.0, 15000.0, exact)
    _, rhs_real, rhs_cplx, fbcat = tk.ct_tables_folded_cat(*args)
    rhs_frag, fb_frag = (t.numpy() for t in tk.ct_fragment_tables(*args))

    def read_back(frag, tile_cols, n_cols):
        """[K/16, tiles, 32, 2] int32 -> [K, n_cols] bf16 bit patterns."""
        out = np.zeros((frag.shape[0] * 16, n_cols), np.uint16)
        for lane in range(32):
            g, c = lane // 4, lane % 4
            for word in range(2):
                w = frag[:, :, lane, word].astype(np.uint32)
                for half, bits in enumerate((w & 0xFFFF, w >> 16)):
                    for j, col0 in enumerate(tile_cols):
                        out[2 * c + 8 * word + half :: 16, col0 + g] = bits[:, j]
        return out

    bits = lambda t: t.contiguous().view(torch.int16).numpy().view(np.uint16)  # noqa: E731
    R, K1 = n_fft // 128, 384 if exact else 128
    blocks, i_real, i_cplx = [], 0, 0
    for r in range(R // 2 + 1):
        if r == 0 or 2 * r == R:
            blocks.append(rhs_real[i_real * K1 : (i_real + 1) * K1])
            i_real += 1
        else:
            blocks.append(rhs_cplx[i_cplx * 2 * K1 : (i_cplx + 1) * 2 * K1])
            i_cplx += 1
    want = bits(torch.cat(blocks))
    assert rhs_frag.shape == (want.shape[0] // 16, 16, 32, 4)
    # warp w's four words: the x_re tile's two, then the x_im tile's two
    tiles = [c for w in range(16) for c in (8 * w, 128 + 8 * w)]
    got = read_back(rhs_frag.reshape(-1, 16, 32, 2, 2).transpose(0, 1, 3, 2, 4).reshape(-1, 32, 32, 2), tiles, 256)
    np.testing.assert_array_equal(got, want)
    n_tiles = -(-n_mels // 8)
    assert fb_frag.shape == (fbcat.shape[0] // 16, n_tiles, 32, 2)
    got = read_back(fb_frag, range(0, 8 * n_tiles, 8), 8 * n_tiles)
    np.testing.assert_array_equal(got[:, :n_mels], bits(fbcat))
    assert not got[:, n_mels:].any()


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
