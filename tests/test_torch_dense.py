"""The dense mel kernel's host side, held against the JAX package on the CPU:
its fragment tables read back as the tensor cores read them, the plain
version of its split arithmetic against the dense Pallas kernel (interpret
mode), the same with f64 sums, and the choice of its frame tile, which must
take every config the FP32 kernel it replaced took. Inputs come from numpy
seeds and go to both packages.

Tolerances, per row against the row's max |reference|. Exact: 2e-5, the
exact tier's bound (test_pallas_frontend.py:33), which the bf16x3 split (no
lo*lo term) must meet against the reference's f32 HIGHEST products.
bf16 mode: the reference's DEFAULT precision is f32 on a CPU, so the port's
rounded operands are held to the bf16 tier's 1e-2 there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anuraxla.constants import MelConfig as JMel
from anuraxla.ops import frontend as jfe
from anuraxla.ops import pallas_frontend as jpf
from anuraxla_torch.constants import DEFAULT_MEL, MelConfig
from anuraxla_torch.ops import mel_kernel as tk

HOP240 = dict(sr=48000, duration=0.5, n_mels=64, fmin=DEFAULT_MEL.fmin, fmax=DEFAULT_MEL.fmax,
              hop_length=240, n_fft=2048, target_frames=32)
N400 = dict(sr=16000, duration=0.5, n_mels=32, fmin=100.0, fmax=7500.0, hop_length=80, n_fft=400,
            target_frames=16)
CONFIGS = {"hop240_n2048": HOP240, "hop80_n400": N400}


def _rows(cfg, B, seed):
    """[B, num_samples] rows and their RMS scales: row 0 silent (the
    sentinel s = -1, raw passthrough), row 1 clips after scaling."""
    rng = np.random.default_rng(seed)
    y = (0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)
    y[0] = 1e-7 * rng.standard_normal(cfg.num_samples)
    y[1] = 0.001 * rng.standard_normal(cfg.num_samples)
    y[1, :: cfg.num_samples // 5] = 0.9
    s = np.array(jfe.rms_scale_batch(jnp.asarray(y)))
    assert s[0] == -1.0 and s[1] > 0
    return y, s


def _centre(y, cfg):
    return torch.nn.functional.pad(torch.from_numpy(y), (cfg.n_fft // 2, cfg.n_fft // 2))


def _row_rel(got, ref):
    """|got - ref| of each row's max |ref|, elementwise, in float64."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref) / np.abs(ref).max(axis=(1, 2), keepdims=True)


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


def _bits(x: np.ndarray, parts: int) -> list:
    """bf16 bit patterns of the (hi, lo) split of an f32 array, or of hi."""
    hi = torch.from_numpy(x).to(torch.bfloat16)
    lo = (torch.from_numpy(x) - hi.float()).to(torch.bfloat16)
    return [t.view(torch.int16).numpy().view(np.uint16) for t in (hi, lo)[:parts]]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "bf16"])
@pytest.mark.parametrize("n_fft,n_mels", [(2048, 64), (400, 20)])
def test_fragment_tables_decode_to_the_split_tables(n_fft, n_mels, exact):
    """``dense_fragment_tables`` read back as ``mma.sync.m16n8k16`` reads its
    B fragments are, bitwise, the bf16 (hi, lo) split (or the bf16 rounding)
    of ``dense_tables``: C and S tile by tile (the last tile ragged), rows
    zero-padded to a multiple of 64, and the filterbank, mel columns
    zero-padded to a multiple of 8."""
    sr, fmin, fmax = (48000, 150.0, 15000.0) if n_fft == 2048 else (16000, 100.0, 7500.0)
    C, S, FB = tk.dense_tables(sr, n_fft, n_mels, fmin, fmax)
    basis, fb = (t.numpy() for t in tk.dense_fragment_tables(sr, n_fft, n_mels, fmin, fmax, exact))
    parts = 2 if exact else 1
    n_freq = n_fft // 2 + 1
    n_freq_pad, k_pad = -(-n_freq // 16) * 16, -(-n_fft // 64) * 64
    assert basis.dtype == np.int32 and basis.size == (k_pad // 16) * (n_freq_pad // 8) * parts * 32 * 4

    # tile by tile: [K/16, groups, parts, 32 lanes, (C w0, C w1, S w0, S w1)]
    got = {"C": [[] for _ in range(parts)], "S": [[] for _ in range(parts)]}
    flat, f0 = basis.reshape(-1), 0
    for f in range(0, n_freq_pad, tk.DENSE_FT):
        groups = min(tk.DENSE_FT, n_freq_pad - f) // 8
        n = (k_pad // 16) * groups * parts * 32 * 4
        tile = flat[f0 : f0 + n].reshape(k_pad // 16, groups, parts, 32, 4)
        f0 += n
        for part in range(parts):
            got["C"][part].append(_read_back(tile[:, :, part, :, :2]))
            got["S"][part].append(_read_back(tile[:, :, part, :, 2:]))
    assert f0 == flat.size
    for name, full in (("C", C), ("S", S)):
        want = np.zeros((k_pad, n_freq_pad), np.float32)
        want[:n_fft] = full[:, :n_freq_pad]
        assert not full[:, n_freq:].any()
        for part, bits in enumerate(_bits(want, parts)):
            np.testing.assert_array_equal(np.concatenate(got[name][part], 1), bits)

    n_tiles = -(-n_mels // 8)
    assert fb.shape == (n_freq_pad // 16, n_tiles, 32, 2 * parts)
    want = np.zeros((n_freq_pad, 8 * n_tiles), np.float32)
    want[:, :n_mels] = FB[:n_freq_pad]
    for part, bits in enumerate(_bits(want, parts)):
        np.testing.assert_array_equal(_read_back(fb[..., 2 * part : 2 * part + 2]), bits)


@pytest.mark.parametrize("label", list(CONFIGS))
def test_split_plain_matches_jax_dense_kernel(label):
    """The plain version of the kernel's split arithmetic against the dense
    Pallas kernel in interpret mode (f32 HIGHEST products), with the fused
    RMS scale, a raw row and a clipping row, at 2e-5 of each row's max; and
    the plain f32 version the wrapper computes on a CPU tensor."""
    cfg = CONFIGS[label]
    tc = MelConfig(**cfg)
    y, s = _rows(tc, 3, seed=41)
    T = tc.total_frames
    ref = np.asarray(jpf.mel_power_pallas(jnp.asarray(y), JMel(**cfg), num_frames=T, interpret=True,
                                          algorithm="dense", rms_scale=jnp.asarray(s)))
    got = tk.mel_power_dense_split_plain(_centre(y, tc), torch.from_numpy(s), tc, T)
    rel = _row_rel(got, ref)
    assert rel.max() <= 2e-5 and rel.mean() <= 2e-6, (rel.max(axis=(1, 2)), rel.mean())
    # it is the split, not a plain f32 product: the difference is above f32 round-off
    plain = tk.mel_power_dense_plain(_centre(y, tc), torch.from_numpy(s), tc, T)
    assert _row_rel(got, plain).max() > 1e-6
    wrapper = tk.mel_power(torch.from_numpy(y), tc, num_frames=T, algorithm="dense", rms_scale=torch.from_numpy(s))
    assert torch.equal(wrapper, plain) and _row_rel(plain, ref).max() <= 2e-5


@pytest.mark.parametrize("label", list(CONFIGS))
def test_split_plain_bf16_mode_is_the_bf16_plain_version(label):
    """``exact=False``: one pass over the rounded operands at the bf16 plain
    version's rounding points, on a frame range: the two differ only where
    their f32 sums (in another order) round a power value to the other bf16
    neighbour. Within the bf16 tier's 1e-2 of the Pallas kernel (whose
    DEFAULT precision is f32 on a CPU)."""
    cfg = CONFIGS[label]
    tc = MelConfig(**cfg)
    y, s = _rows(tc, 3, seed=42)
    first, T = 3, tc.total_frames - 5
    x, sc = _centre(y, tc), torch.from_numpy(s)
    got = tk.mel_power_dense_split_plain(x, sc, tc, T, first_frame=first, exact=False)
    rel = _row_rel(got, tk.mel_power_dense_plain(x, sc, tc, T, first_frame=first, exact=False))
    assert rel.mean() <= 2e-6 and rel.max() <= 2.0**-7
    ref = np.asarray(jpf.mel_power_pallas(jnp.asarray(y), JMel(**cfg), num_frames=first + T, interpret=True,
                                          algorithm="dense", exact=False, rms_scale=jnp.asarray(s)))[:, first:]
    assert _row_rel(got, ref).max() <= 1e-2


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "bf16"])
@pytest.mark.parametrize("label", list(CONFIGS))
def test_split_plain_f64_sums_keep_the_rounding_points(label, exact):
    """``sums=torch.float64`` changes the sums' precision only, so the two
    differ where a split or rounded value lands on the other bf16
    neighbour. Exact mode: a power value's hi half that rounds the other way
    is made up by its lo half, a lo half that does moves the value by one
    step of the lo half, at most 2^-16 of it (read: up to 7.6e-6 of a row's
    max, mean 4e-8). bf16 mode: single values differ by a flipped bf16
    rounding (at most 2^-7 of a row's max) while the mean stays at round-off;
    and f64 sums do not make the bf16 mode the exact one."""
    tc = MelConfig(**CONFIGS[label])
    y, s = _rows(tc, 3, seed=43)
    x, sc, T = _centre(y, tc), torch.from_numpy(s), tc.total_frames
    f32 = tk.mel_power_dense_split_plain(x, sc, tc, T, exact=exact)
    f64 = tk.mel_power_dense_split_plain(x, sc, tc, T, exact=exact, sums=torch.float64)
    assert f64.dtype == torch.float32 and f64.shape == f32.shape
    rel = _row_rel(f32, f64)
    assert rel.mean() <= (2e-7 if exact else 2e-6)
    assert rel.max() <= (2.0**-16 if exact else 2.0**-7)
    if not exact:
        exact64 = tk.mel_power_dense_split_plain(x, sc, tc, T, sums=torch.float64)
        assert _row_rel(f64, exact64).mean() > 1e-4


def _fp32_kernel_took(n_fft: int, hop: int) -> bool:
    """Whether the FP32 dense kernel this one replaced fit a block: its
    shared memory was the f32 window of 31·hop + n_fft samples (rounded up to
    4) and a 32 x 128 f32 power tile."""
    return (-(-(31 * hop + n_fft) // 4) * 4) * 4 + 32 * 128 * 4 <= tk.SMEM_LIMIT


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "bf16"])
@pytest.mark.parametrize("hops", [range(16, 256, 16), range(256, 1024, 16), range(1024, 1760, 16)],
                         ids=["hop16-240", "hop256-1008", "hop1024-1744"])
def test_tile_choice_takes_every_config_the_fp32_kernel_took(hops, exact):
    """For every hop % 16 config whose window fit the FP32 kernel, up to its
    largest n_fft, ``dense_tile`` finds a tile whose shared memory fits, the
    most frames a block that fit; the main path's configs get 128 frames."""
    for hop in hops:
        n_max = max(n for n in range(54016 - 31 * hop - 8, 54016 - 31 * hop + 8) if _fp32_kernel_took(n, hop))
        assert not _fp32_kernel_took(n_max + 1, hop)
        for n_fft in (2, 3, 16, 400, 2048, 4095, n_max // 2, n_max - 1, n_max):
            cfg = MelConfig(n_fft=n_fft, hop_length=hop)
            assert tk.kernel_supported(cfg, "dense")
            tile = tk.dense_tile(n_fft, hop, exact)
            assert tile is not None, (n_fft, hop)
            assert tk.dense_smem_bytes(n_fft, hop, tile, exact) <= tk.SMEM_LIMIT
            earlier = tk.DENSE_TILES[: tk.DENSE_TILES.index(tile)]
            assert all(tk.dense_smem_bytes(n_fft, hop, t, exact) > tk.SMEM_LIMIT for t in earlier)
    for n_fft, hop in ((2048, 240), (400, 80)):
        assert tk.dense_tile(n_fft, hop, exact)[0] == 128
