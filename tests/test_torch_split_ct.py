"""The Cooley–Tukey kernel's host side, held against the JAX package on the
CPU: its fragment tables read back as the tensor cores read them, the plain
version of its split arithmetic (``mel_power_ct_split_plain``, the
reference's ``_ct_outer_stage``) against the phase and stack Pallas kernels
in interpret mode, the same with f64 sums, and the choice of its frame tile,
which must take every config the FP32 kernel it replaced took. Inputs come
from numpy seeds and go to both packages.

Tolerances, per row against the row's max |reference|. The split twin
against the Pallas kernel: 2e-5, the exact tier's bound
(test_pallas_frontend.py:33), with the mean at 2e-6. Both compute the same
bf16 products at the same rounding points and differ in the order of their f32
sums only; a power value whose split lands its lo half on the other bf16
neighbour moves by one step of the lo half, at most 2^-17 of the value, so
that is the bound on the worst single value (read: up to 4.0e-6) and the mean
is held to 2e-7 (read: up to 7.5e-8); a misplaced rounding point would move
every value by ~1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anuraxla.constants import MelConfig as JMel
from anuraxla.ops import pallas_frontend as jpf
from anuraxla_torch.constants import MelConfig
from anuraxla_torch.ops import mel_kernel as tk

R16 = dict(sr=48000, duration=0.5, n_mels=64, fmin=150.0, fmax=15000.0,
           hop_length=384, n_fft=2048, target_frames=48)
R4 = dict(sr=16000, duration=0.5, n_mels=32, fmin=100.0, fmax=7500.0,
          hop_length=128, n_fft=512, target_frames=32)


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
    """|got - ref| of each row's max |ref|, elementwise, in float64."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref) / np.abs(ref).max(axis=(1, 2), keepdims=True)


def _centre(y, cfg):
    return torch.nn.functional.pad(torch.from_numpy(y), (cfg.n_fft // 2, cfg.n_fft // 2))


def _read_back(frag):
    """[K/16, tiles, 32, 2] int32 B fragments -> [K, 8 * tiles] bf16 bit
    patterns (lane 4g + c: column g, rows 2c, 2c+1 in word 0 and 2c+8, 2c+9
    in word 1, the lower row in the lower half)."""
    out = np.zeros((frag.shape[0] * 16, 8 * frag.shape[1]), np.uint16)
    for lane in range(32):
        g, c = lane // 4, lane % 4
        for word in range(2):
            w = frag[:, :, lane, word].astype(np.uint32)
            for half, bits in enumerate((w & 0xFFFF, w >> 16)):
                out[2 * c + 8 * word + half :: 16, g::8] = bits
    return out


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "bf16"])
@pytest.mark.parametrize("n_fft,n_mels", [(2048, 64), (512, 20), (256, 128)])
def test_split_fragment_tables_hold_the_folded_tables(n_fft, n_mels, exact):
    """``ct_split_fragment_tables`` read back as ``mma.sync.m16n8k16`` reads
    its B fragments are, bitwise, the bf16 (hi, lo) split of
    ``ct_tables_folded`` (C and S of every r, each stored once, C's words
    then S's of the same bins) and of the merged filterbank (mel columns
    zero-padded to a multiple of 8); the bf16 mode's are the ``hi`` halves
    that ``ct_tables_bf16`` gives. hi + lo rebuilds each f32 table within
    2^-16 of each value."""
    args = (48000, n_fft, n_mels, 150.0, 15000.0)
    C, S, FBM, _ = tk.ct_tables_folded(*args)
    rhs, fb = (t.numpy() for t in tk.ct_split_fragment_tables(*args, exact))
    parts = 2 if exact else 1
    n_half = n_fft // 128 // 2 + 1
    n_tiles = -(-n_mels // 8)
    assert rhs.dtype == fb.dtype == np.int32
    assert rhs.shape == (n_half * 8, 16, parts, 32, 4) and fb.shape == (n_half * 8, n_tiles, 32, 2 * parts)
    halves = {}
    for name, full, frag in (("C", C, rhs[..., :2]), ("S", S, rhs[..., 2:])):
        hi, lo = tk._split_bf16(torch.from_numpy(full))
        halves[name] = (hi, lo)
        for part, want in enumerate((hi, lo)[:parts]):
            np.testing.assert_array_equal(_read_back(frag[:, :, part]), _bits(want.to(torch.bfloat16)))
    F = np.zeros((FBM.shape[0], 8 * n_tiles), np.float32)
    F[:, :n_mels] = FBM
    fhi, flo = tk._split_bf16(torch.from_numpy(F))
    for part, want in enumerate((fhi, flo)[:parts]):
        np.testing.assert_array_equal(_read_back(fb[..., 2 * part : 2 * part + 2]), _bits(want.to(torch.bfloat16)))
    if exact:
        for full, (hi, lo) in ((C, halves["C"]), (S, halves["S"]), (F, (fhi, flo))):
            err = np.abs((hi + lo).double().numpy() - full)
            assert (err <= 2.0 ** -16 * np.abs(full)).all()
    else:
        for want, (hi, _) in zip(tk.ct_tables_bf16(*args)[:2], (halves["C"], halves["S"])):
            assert torch.equal(want, hi.to(torch.bfloat16))


CASES = {
    # (config, pre-padded rows, first_frame, frames: None = the whole clip)
    "r16_pre_padded_range": (R16, True, 7, 30),
    "r16": (R16, False, 0, None),
    "r4_pre_padded": (R4, True, 0, None),
    "hop96_n512": (dict(R4, hop_length=96, n_mels=20), False, 0, None),
    "hop160": (dict(R16, hop_length=160, duration=0.25), False, 0, None),
    "hop320_range": (dict(R16, hop_length=320), False, 5, 40),
}


def _case(label, seed):
    """(cfg, the rows the JAX kernel and the wrapper take, the same rows
    centre-padded, scale, first_frame, num_frames, JAX keywords)."""
    kw, pre_padded, first, T = CASES[label]
    cfg = MelConfig(**kw)
    y, scale = _rows(cfg, 3, seed)
    T = cfg.total_frames if T is None else T
    if not pre_padded:
        return cfg, y, _centre(y, cfg), scale, first, T, {}
    L_pad, off = tk.phase_padded_layout(cfg, first + T)
    rows = np.zeros((3, L_pad), np.float32)
    n = min(cfg.num_samples, L_pad - off)
    rows[:, off : off + n] = y[:, :n]
    return cfg, rows, torch.from_numpy(rows), scale, first, T, dict(pre_padded=True, assembly="phase")


@pytest.mark.parametrize("label", list(CASES))
def test_split_plain_matches_jax(label):
    """The plain version of the kernel's split arithmetic against the Pallas
    kernel in interpret mode at R = 16 (radix 4x4) and R = 4 (literal
    weights), at hop % 128 with pre-padded rows and at hop % 32 (96 / 160 /
    320, the stack kernel), on frame ranges, with a raw row (s <= 0), a
    clipping row and a scaled row: within 2e-5 of each row's max, mean 2e-6.
    It is the split, not plain f32 (their difference is above f32
    round-off), and the wrapper on a CPU tensor still computes plain f32."""
    cfg, rows, centred, scale, first, T, jkw = _case(label, seed=51)
    jcfg = JMel(**CASES[label][0])
    want = np.asarray(jpf.mel_power_pallas(jnp.asarray(rows), jcfg, num_frames=first + T, interpret=True,
                                           algorithm="ct", rms_scale=jnp.asarray(scale), **jkw))[:, first:]
    s = torch.from_numpy(scale)
    got = tk.mel_power_ct_split_plain(centred, s, cfg, T, first_frame=first)
    assert got.shape == (3, T, cfg.n_mels) and got.dtype == torch.float32
    rel = _row_rel(got, want)
    assert rel.max() <= 2e-5 and rel.mean() <= 2e-6, (rel.max(axis=(1, 2)), rel.mean())
    plain = tk.mel_power_ct_plain(centred, s, cfg, T, first_frame=first)
    assert _row_rel(got, plain).max() > 1e-7
    wrapper = tk.mel_power(torch.from_numpy(rows), cfg, num_frames=T, first_frame=first, rms_scale=s,
                           pre_padded=bool(jkw))
    assert torch.equal(wrapper, plain)


@pytest.mark.parametrize("label", ["r16", "r4_pre_padded"])
def test_split_plain_keeps_the_reference_rounding_points(label):
    """Closer than the tier's gate: the twin and the Pallas kernel round the
    same values to bf16 at the same points and differ only in the order of
    their f32 sums, so no value differs by more than one step of a power
    value's lo half (2^-17 of it) and the mean stays at f32 round-off
    (<= 2e-7). The plain f32 version is further off on average."""
    cfg, rows, centred, scale, first, T, jkw = _case(label, seed=52)
    want = np.asarray(jpf.mel_power_pallas(jnp.asarray(rows), JMel(**CASES[label][0]), num_frames=T,
                                           interpret=True, algorithm="ct", rms_scale=jnp.asarray(scale), **jkw))
    s = torch.from_numpy(scale)
    rel = _row_rel(tk.mel_power_ct_split_plain(centred, s, cfg, T), want)
    assert rel.max() <= 2.0 ** -17 and rel.mean() <= 2e-7, (rel.max(), rel.mean())
    assert _row_rel(tk.mel_power_ct_plain(centred, s, cfg, T), want).mean() > 2 * rel.mean()


@pytest.mark.parametrize("label", ["r16", "hop96_n512"])
def test_split_plain_f64_sums_keep_the_rounding_points(label):
    """``sums=torch.float64`` changes the sums' precision only: the two
    differ where a split value lands on the other bf16 neighbour, by at most
    one step of the lo half."""
    cfg, _, centred, scale, first, T, _ = _case(label, seed=53)
    s = torch.from_numpy(scale)
    f32 = tk.mel_power_ct_split_plain(centred, s, cfg, T, first_frame=first)
    f64 = tk.mel_power_ct_split_plain(centred, s, cfg, T, first_frame=first, sums=torch.float64)
    assert f64.dtype == torch.float32 and f64.shape == f32.shape
    rel = _row_rel(f32, f64)
    assert rel.max() <= 2.0 ** -16 and rel.mean() <= 2e-7, (rel.max(), rel.mean())


def test_split_plain_bf16_mode_is_the_bf16_plain_version():
    """``exact=False``: one bf16 pass, the plain bf16 version itself, f64
    sums and ablations included."""
    cfg, _, centred, scale, first, T, _ = _case("hop320_range", seed=54)
    s = torch.from_numpy(scale)
    for kw in (dict(), dict(sums=torch.float64), dict(ablate=("power",))):
        got = tk.mel_power_ct_split_plain(centred, s, cfg, T, first_frame=first, exact=False, **kw)
        assert torch.equal(got, tk.mel_power_ct_plain(centred, s, cfg, T, first_frame=first, exact=False, **kw))


def test_cpu_ablated_exact_call_routes_to_the_split_plain_version():
    """On a CPU tensor an ablated exact call computes the split arithmetic of
    the instantiations it profiles; an intact one stays plain f32, and nothing
    launches."""
    cfg, rows, centred, scale, _, T, _ = _case("r16", seed=55)
    s = torch.from_numpy(scale)
    before = dict(tk.mel_power.launches)
    for ablate in (("window",), ("splits",), ("dots", "fb")):
        got = tk.mel_power(torch.from_numpy(rows), cfg, num_frames=T, rms_scale=s, ablate=ablate)
        assert torch.equal(got, tk.mel_power_ct_split_plain(centred, s, cfg, T, ablate=ablate))
    with pytest.raises(ValueError, match="mel_power_ct_split_plain"):
        tk.mel_power_ct_plain(centred, s, cfg, T, ablate=("dots",))
    assert tk.mel_power.launches == before


def _fp32_kernel_took(n_fft: int, hop: int) -> bool:
    """Whether the FP32 FFMA kernel this one replaced fit a block: its shared
    memory was the f32 window of 31·hop + n_fft samples (rounded up to 4) and
    five 32 x 128 f32 tiles (four planes and the power)."""
    return (-(-(31 * hop + n_fft) // 4) * 4 + 5 * 32 * 128) * 4 <= tk.SMEM_LIMIT


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
def test_tile_choice_takes_every_config_the_fp32_kernel_took(n_fft):
    """For every hop % 32 up to the longest the FP32 kernel admitted at this
    n_fft, ``ct_tile`` finds a frame tile whose shared memory fits, in either
    mode, the most frames a block that fit; the main path's configs get 64."""
    hops = [h for h in range(32, 2048, 32) if _fp32_kernel_took(n_fft, h)]
    assert hops and not _fp32_kernel_took(n_fft, hops[-1] + 32)
    for hop in hops:
        assert tk.kernel_supported(MelConfig(n_fft=n_fft, hop_length=hop), "ct")
        for exact in (True, False):
            tf = tk.ct_tile(n_fft, hop, exact)
            assert tf is not None, (n_fft, hop, exact)
            assert tk.ct_smem_bytes(n_fft, hop, tf, exact) <= tk.SMEM_LIMIT
            earlier = tk.CT_TILES[: tk.CT_TILES.index(tf)]
            assert all(tk.ct_smem_bytes(n_fft, hop, t, exact) > tk.SMEM_LIMIT for t in earlier)
    if n_fft == 2048:
        for hop in (384, 320, 160):
            assert tk.ct_tile(n_fft, hop, True) == tk.ct_tile(n_fft, hop, False) == 64
