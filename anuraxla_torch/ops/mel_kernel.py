"""Fused mel power — the port of ``anuraxla/ops/pallas_frontend.py``: its
three TPU kernels and ``mel_power_pallas``, the function that selects one.

- ``phase_padded_layout`` / ``kernel_supported``: copies of the reference's
  ``phase_padded_layout`` and ``pallas_supported`` (the same gate), so host
  decoders produce the rows the reference's kernel would read.
- ``ct_tables_folded``: the twiddle-folded Cooley–Tukey tables C/S, the
  merged filterbank FBM and the window, in float32 rounded from the same
  float64 construction as the reference's ``_ct_tables_folded`` (which
  splits them into bf16 hi/lo pairs for the TPU's matrix unit instead);
  ``ct_tables_bf16``: the bf16 ``hi`` halves the bf16 mode multiplies by,
  bitwise the reference's. ``dense_tables``: the windowed DFT bases and the
  filterbank of the dense kernel, frequency axis zero-padded to 128s.
- ``ct_tables_folded_cat``: the concatenated-operand tables of the
  reference's ``_ct_tables_folded_cat`` (``fused_dots=True``), bitwise, and
  ``ct_fragment_tables``: the same values in the order the tensor cores'
  ``mma`` fragments read them. ``ct_split_fragment_tables``: ``ct_tables_folded``
  split into bf16 (hi, lo) pairs (or rounded to bf16), each stored once, in
  the Cooley–Tukey kernel's fragment order; ``ct_tile``: its frame tile.
  ``dense_fragment_tables``: ``dense_tables``
  split into bf16 (hi, lo) pairs (or rounded to bf16) in the dense kernel's
  fragment order; ``dense_tile``: the dense kernel's frame tile and ring.
- ``mel_power_ct_plain`` / ``mel_power_ct_fused_plain`` /
  ``mel_power_dense_plain``: the plain PyTorch versions of the kernels' math,
  exact and bf16; ``mel_power_ct_split_plain`` / ``mel_power_dense_split_plain``:
  the Cooley–Tukey and dense kernels' split arithmetic (bf16×3 in the exact
  mode), against which the card holds them.
- ``mel_power``: the wrapper. On a CUDA tensor it launches a hand-written
  Hopper kernel (``csrc/mel_power_ct.cu``, ``csrc/mel_power_ct_split.cu`` or
  ``csrc/mel_power_dense.cu``) or raises; it takes a plain version only for a
  tensor on the CPU. ``mel_power.launches`` counts the kernel launches by
  kernel and mode.

Which kernel runs (``kernel_name``):

=====================  =========  =====  ==================================
name                   algorithm  exact  config
=====================  =========  =====  ==================================
``mel_power_ct``       ct         yes    n_fft % 128 == 0, hop % 128 == 0
``mel_power_ct_hop32`` ct         yes    n_fft % 128 == 0, hop % 32 == 0
``mel_power_ct_bf16``  ct         no     n_fft % 128 == 0, hop % 32 == 0
``mel_power_dense``    dense      yes    hop % 16 == 0
``mel_power_dense_bf16`` dense    no     hop % 16 == 0
``mel_power_ct_fused`` ct         yes    ``fused_dots=True``, hop % 32 == 0
``mel_power_ct_fused_bf16`` ct    no     ``fused_dots=True``, hop % 32 == 0
=====================  =========  =====  ==================================

The first three are one source (``mel_power_ct.cu``): on this card a frame
is read at any sample offset, so the reference's separate kernel for
hop % 128 != 0 needs no code of its own. Every kernel runs on the tensor
cores; every exact mode is the reference's bf16×3 split (``mel_power_ct.cu``:
the reference's ``_ct_outer_stage``; ``csrc/mel_power_dense.cu``: the dense
kernel's).
``fused_dots=True`` is the kernel-study variant (``csrc/mel_power_ct_split.cu``):
the outer stage as one deep product per r over bf16 hi/lo split operands, on
the tensor cores.
``ablate=`` (profiling only, wrong output by design) drops classes of work
from the Cooley–Tukey kernel at hop % 128 == 0; its launches count under the
kernel's own name.

The reference's ``tile_t``, ``row_block``, ``batch_rows``, ``assembly`` and
``interleave`` are blocking and scheduling knobs of its compiler with no
counterpart here, where one source serves every hop family.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from anuraxla_torch.constants import MelConfig
from anuraxla_torch.ops.mel import mel_filterbank
from anuraxla_torch.ops.stft import _dft_bases, frames_of_padded, hann_window, round_bf16
from anuraxla_torch.utils.precision import exact_f32

TILE_T = 128  # the reference kernel's frame tile; fixes the padded row length
MAX_MELS = 128


def phase_padded_layout(cfg: MelConfig, num_frames: int) -> tuple[int, int]:
    """(L_pad, pad_l) of the pre-padded row layout for ``hop % 128 == 0``
    configs: a row is ``L_pad`` samples with the signal at ``pad_l``
    (= n_fft//2, librosa center=True) and zeros elsewhere. Copy of the
    reference's ``phase_padded_layout``, so both packages read the same
    rows."""
    hop, n_fft = cfg.hop_length, cfg.n_fft
    if hop % 128 != 0:
        raise NotImplementedError(
            f"pre-padded layout is defined for the phase kernel "
            f"(hop % 128 == 0), got hop={hop}"
        )
    h128 = hop // 128
    R = n_fft // 128
    qmax = (R - 1) // h128
    W2 = 1 + (TILE_T - 1 + qmax) // TILE_T
    n_t_tiles = -(-num_frames // TILE_T)
    n_mrows = n_t_tiles - 1 + W2
    return n_mrows * TILE_T * hop, n_fft // 2


def kernel_supported(cfg: MelConfig, algorithm: str = "auto") -> bool:
    """The reference's support gate (``pallas_supported``): ct needs n_fft a
    >= 2 multiple of 128 and hop % 32 == 0; dense needs hop % 16 == 0."""
    hop, n_fft = cfg.hop_length, cfg.n_fft
    ct_ok = n_fft % 128 == 0 and n_fft >= 256 and hop % 32 == 0
    dense_ok = (8 * hop) % 128 == 0
    if algorithm == "ct":
        return ct_ok
    if algorithm == "dense":
        return dense_ok
    return ct_ok or dense_ok


def resolve_algorithm(cfg: MelConfig, algorithm: str = "auto") -> str:
    """"ct" or "dense" for (cfg, algorithm): "auto" takes ct where it can,
    else dense. The one place that refuses a config — with the reference's
    refusals (``mel_power_pallas``), and above 128 mels (the kernels keep a
    frame's mels in 4 registers a lane)."""
    hop, n_fft = cfg.hop_length, cfg.n_fft
    if algorithm not in ("auto", "ct", "dense"):
        raise ValueError(f"algorithm must be auto/ct/dense, got {algorithm!r}")
    ct_ok = kernel_supported(cfg, "ct")
    if not kernel_supported(cfg, algorithm):
        raise NotImplementedError({
            "auto": f"the mel kernels need hop_length % 32 == 0 (ct) or % 16 == 0 "
                    f"(dense); got hop={hop}. Use backend='matmul'.",
            "ct": f"ct kernel needs n_fft a >=2 multiple of 128 and hop % 32 == 0, "
                  f"got n_fft={n_fft}, hop={hop}",
            "dense": f"dense kernel needs hop % 16 == 0, got {hop}",
        }[algorithm])
    if cfg.n_mels > MAX_MELS:
        raise NotImplementedError(f"the mel kernels take at most {MAX_MELS} mels, got {cfg.n_mels}")
    return ("ct" if ct_ok else "dense") if algorithm == "auto" else algorithm


def kernel_takes(cfg: MelConfig, algorithm: str = "auto") -> bool:
    """Whether a Hopper kernel computes this config (``resolve_algorithm``
    does not refuse it)."""
    try:
        resolve_algorithm(cfg, algorithm)
    except NotImplementedError:
        return False
    return True


def kernel_name(cfg: MelConfig, algorithm: str, exact: bool, fused_dots: bool = False) -> str:
    """The launch counter's key for a resolved algorithm (module docstring)."""
    if fused_dots:
        return "mel_power_ct_fused" if exact else "mel_power_ct_fused_bf16"
    if algorithm == "dense":
        return "mel_power_dense" if exact else "mel_power_dense_bf16"
    if not exact:
        return "mel_power_ct_bf16"
    return "mel_power_ct" if cfg.hop_length % 128 == 0 else "mel_power_ct_hop32"


@functools.lru_cache(maxsize=8)
def ct_tables_folded(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float):
    """(C, S, FBM, win) as float32 numpy arrays.

    With n = n1·128 + n2 (R = n_fft/128 blocks) and k = q·R + r:
    - C/S [(R//2+1)·128, 128]: row r·128+n2 holds cos/sin(2π n2 (q·R+r)/n_fft),
      the twiddle W_nfft^{n2 r} folded into the outer DFT-128 base;
    - FBM [(R//2+1)·128, n_mels]: merged filterbank. Real input gives
      |X[n_fft−k]| = |X[k]|, so block R−r at column q equals block r at
      column 127−q and its filterbank rows fold into block r reversed;
      blocks r > R/2 are never computed;
    - win [n_fft]: periodic Hann.
    """
    R = n_fft // 128
    n_freq = n_fft // 2 + 1
    n_half = R // 2 + 1
    n2 = np.arange(128, dtype=np.float64)[:, None]
    q = np.arange(128, dtype=np.float64)[None, :]
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    C = np.zeros((n_half * 128, 128), np.float64)
    S = np.zeros_like(C)
    FBM = np.zeros((n_half * 128, n_mels), np.float64)
    for r in range(n_half):
        ang = 2.0 * np.pi * n2 * (q * R + r) / n_fft
        C[r * 128 : (r + 1) * 128] = np.cos(ang)
        S[r * 128 : (r + 1) * 128] = np.sin(ang)
        self_paired = r == 0 or 2 * r == R
        for qq in range(128):
            k = qq * R + r
            if k < n_freq:
                FBM[r * 128 + qq] += fb[k]
            if not self_paired:
                kp = (127 - qq) * R + (R - r)
                if kp < n_freq:
                    FBM[r * 128 + qq] += fb[kp]
    f32 = lambda a: np.ascontiguousarray(a.astype(np.float32))  # noqa: E731
    return f32(C), f32(S), f32(FBM), hann_window(n_fft)


@functools.lru_cache(maxsize=8)
def inner_weights(R: int) -> np.ndarray:
    """[R, 2] (cos, sin) of 2πj/R in float32, snapped to exact 0/±1 where
    the angle is a multiple of π/2 (as the reference's literal weights)."""
    ang = 2.0 * np.pi * np.arange(R, dtype=np.float64) / R
    w = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    w[np.abs(w) < 1e-12] = 0.0
    snap = np.abs(np.abs(w) - 1.0) < 1e-12
    w[snap] = np.round(w[snap])
    return w.astype(np.float32)


def ct_tables_bf16(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float):
    """(C, S, FBM) as bf16 tensors: the ``hi`` halves of the reference's
    split tables (``_split_bf16_np``: float64 -> float32 -> bf16), which
    alone serve its bf16 mode."""
    C, S, FBM, _ = ct_tables_folded(sr, n_fft, n_mels, fmin, fmax)
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (C, S, FBM))


def _split_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo) holding bf16 values in x's dtype, hi + lo ~ x: hi = bf16(x),
    lo = bf16(x - hi) (the reference's ``_split_bf16``)."""
    hi = round_bf16(x.float()).to(x.dtype)
    return hi, round_bf16((x - hi).float()).to(x.dtype)


@functools.lru_cache(maxsize=8)
def ct_tables_folded_cat(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float, exact: bool):
    """(win, rhs_real, rhs_cplx, fbcat): the concatenated-operand tables of
    ``fused_dots=True`` — ``win`` [n_fft] f32 numpy, the rest bf16 tensors,
    value for value the reference's ``_ct_tables_folded_cat``.

    Each r is ONE product ``[ar_hi ar_hi ar_lo (ai_hi ai_hi ai_lo)] @ RHS_r
    -> x_re | x_im`` with the split structure and the sign of x_im folded
    into RHS_r: row blocks (C_hi|-S_hi; C_lo|-S_lo; C_hi|-S_hi) for the
    ``ar`` columns and (S_hi|C_hi; S_lo|C_lo; S_hi|C_hi) for ``ai``; the
    filterbank likewise, ``[p_hi p_hi p_lo] @ (F_hi; F_lo; F_hi)``. With
    K1 = 384 (exact) or 128 (bf16 mode: the hi blocks alone):
    rhs_real [n_real*K1, 256] holds r = 0 and (R even) r = R/2 in ascending
    order, rhs_cplx [n_cplx*2*K1, 256] the other r <= R/2 (empty for R = 2),
    fbcat [(R//2+1)*K1, n_mels] every r."""
    R = n_fft // 128
    C, S, FBM, win = (torch.from_numpy(a) for a in ct_tables_folded(sr, n_fft, n_mels, fmin, fmax))
    (Chi, Clo), (Shi, Slo), (Fhi, Flo) = (_split_bf16(t) for t in (C, S, FBM))
    parts = (0, 1, 0) if exact else (0,)  # (hi, lo, hi) against an [a_hi a_hi a_lo] operand
    rhs_real, rhs_cplx, fbcat = [], [], []
    for r in range(R // 2 + 1):
        sl = slice(r * 128, (r + 1) * 128)
        ar_rows = torch.cat([torch.cat([(Chi, Clo)[i][sl], -(Shi, Slo)[i][sl]], 1) for i in parts])
        ai_rows = torch.cat([torch.cat([(Shi, Slo)[i][sl], (Chi, Clo)[i][sl]], 1) for i in parts])
        fbcat.append(torch.cat([(Fhi, Flo)[i][sl] for i in parts]))
        if r == 0 or 2 * r == R:
            rhs_real.append(ar_rows)
        else:
            rhs_cplx.append(torch.cat([ar_rows, ai_rows]))
    rhs_cplx = torch.cat(rhs_cplx) if rhs_cplx else torch.zeros((0, 256))
    return (win.numpy(),) + tuple(t.to(torch.bfloat16) for t in (torch.cat(rhs_real), rhs_cplx, torch.cat(fbcat)))


def _mma_b_fragments(B: torch.Tensor, tile_cols) -> torch.Tensor:
    """A bf16 [K, N] right-hand matrix in the order the B fragments of
    ``mma.sync.m16n8k16`` read it: int32 [K/16, len(tile_cols), 32, 2], where
    tile j covers the 8 columns from ``tile_cols[j]`` and lane l = 4g + c holds
    column g, rows 16k + 2c, +1 (word 0) and 16k + 2c + 8, +9 (word 1), the
    lower row in the lower half of the word. One 8- or 16-byte load a lane
    then feeds a whole ``mma``."""
    K, _ = B.shape
    bits = B.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    ks = torch.arange(K // 16)[:, None, None, None]
    col = torch.as_tensor(list(tile_cols))[None, :, None, None] + (torch.arange(32) // 4)[None, None, :, None]
    row = 16 * ks + 2 * (torch.arange(32) % 4)[None, None, :, None] + 8 * torch.arange(2)[None, None, None, :]
    lo, hi = bits[row, col], bits[row + 1, col]
    return (lo | (hi << 16)).to(torch.int32).contiguous()


@functools.lru_cache(maxsize=8)
def ct_fragment_tables(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float, exact: bool):
    """(rhs_frag, fb_frag) int32 tensors: ``ct_tables_folded_cat`` as
    ``csrc/mel_power_ct_split.cu`` reads it. ``rhs_frag`` [sum_r K_r/16, 16, 32, 4]
    holds the RHS blocks in r order (real or complex as r needs); warp w's
    four words a lane are the fragments of the x_re columns 8w.. and of the
    x_im columns 128 + 8w... ``fb_frag`` [n_half*K1/16, ceil(n_mels/8), 32, 2]
    holds the filterbank blocks, mel columns zero-padded to a multiple of 8."""
    R = n_fft // 128
    _, rhs_real, rhs_cplx, fbcat = ct_tables_folded_cat(sr, n_fft, n_mels, fmin, fmax, exact)
    K1 = 384 if exact else 128
    tiles = [c for w in range(16) for c in (8 * w, 128 + 8 * w)]
    frags, i_real, i_cplx = [], 0, 0
    for r in range(R // 2 + 1):
        if r == 0 or 2 * r == R:
            block = rhs_real[i_real * K1 : (i_real + 1) * K1]
            i_real += 1
        else:
            block = rhs_cplx[i_cplx * 2 * K1 : (i_cplx + 1) * 2 * K1]
            i_cplx += 1
        # [k, (warp, re|im), lane, word] -> [k, warp, lane, (re|im, word)]
        frag = _mma_b_fragments(block, tiles).reshape(-1, 16, 2, 32, 2)
        frags.append(frag.permute(0, 1, 3, 2, 4).reshape(-1, 16, 32, 4))
    n_tiles = -(-n_mels // 8)
    fb = F.pad(fbcat.float(), (0, 8 * n_tiles - n_mels)).to(torch.bfloat16)
    return torch.cat(frags).contiguous(), _mma_b_fragments(fb, range(0, 8 * n_tiles, 8))


@functools.lru_cache(maxsize=8)
def ct_split_fragment_tables(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float, exact: bool):
    """(rhs_frag, fb_frag) int32 tensors: the folded C, S and merged FBM of
    :func:`ct_tables_folded` split into bf16 (hi, lo) pairs (``exact``) or
    rounded to bf16 (the ``hi`` alone, bitwise :func:`ct_tables_bf16`), each
    stored once, in the order ``csrc/mel_power_ct.cu``'s ``mma.sync.m16n8k16``
    B fragments read them.

    ``rhs_frag`` [(R//2+1)·8, 16, parts, 32, 4]: k16 step s of block r at
    s + 8r (K = n2), n8 group j of q, part (hi, lo) or (hi,); lane 4g + c
    holds column q = 8j + g — words 0, 1 of C's fragment, then 2, 3 of S's —
    so one 16-byte load a lane feeds the x_re and x_im products of the same
    bins. ``fb_frag`` [(R//2+1)·8, ceil(n_mels/8), 32, 2·parts]: FBM's
    fragments (K = q), hi words then lo words, the mel columns zero-padded to
    a multiple of 8."""
    C, S, FBM, _ = (torch.from_numpy(a) for a in ct_tables_folded(sr, n_fft, n_mels, fmin, fmax))
    parts = 2 if exact else 1
    Cp, Sp, Fp = (tuple(t.to(torch.bfloat16) for t in _split_bf16(m))[:parts] for m in (C, S, FBM))
    groups = range(0, 128, 8)
    rhs = torch.stack([torch.cat([_mma_b_fragments(c, groups), _mma_b_fragments(s, groups)], -1)
                       for c, s in zip(Cp, Sp)], 2)
    n_tiles = -(-n_mels // 8)
    fb = torch.cat([_mma_b_fragments(F.pad(f.float(), (0, 8 * n_tiles - n_mels)).to(torch.bfloat16),
                                     range(0, 8 * n_tiles, 8)) for f in Fp], -1)
    return rhs.contiguous(), fb.contiguous()


@functools.lru_cache(maxsize=8)
def dense_tables(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float):
    """(C, S, FB) of the dense kernel as float32 numpy arrays: the windowed
    DFT bases [n_fft, n_freq_pad] and the filterbank [n_freq_pad, n_mels],
    the frequency axis zero-padded to a multiple of 128 (exact-zero
    contributions), as the reference's ``_padded_tables``."""
    cos_b, sin_b = _dft_bases(n_fft)
    fb = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    pad = -cos_b.shape[1] % 128
    return (
        np.ascontiguousarray(np.pad(cos_b, ((0, 0), (0, pad)))),
        np.ascontiguousarray(np.pad(sin_b, ((0, 0), (0, pad)))),
        np.ascontiguousarray(np.pad(fb, ((0, pad), (0, 0)))),
    )


DENSE_FT = 64  # frequencies of a dense kernel tile: 8 groups of 8 bins
DENSE_KC = 64  # the dense bases' rows are padded to a multiple of this (the widest K chunk)


def _dense_split_tables(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float, exact: bool):
    """(C, S, FB) parts as bf16 tensors: ``dense_tables`` split into (hi, lo)
    (``exact``) or rounded to bf16 (the ``hi`` alone), each a tuple."""
    mats = [torch.from_numpy(a) for a in dense_tables(sr, n_fft, n_mels, fmin, fmax)]
    return [tuple(t.to(torch.bfloat16) for t in _split_bf16(m))[: 2 if exact else 1] for m in mats]


@functools.lru_cache(maxsize=8)
def dense_fragment_tables(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float, exact: bool):
    """(basis_frag, fb_frag) int32 tensors: the dense kernel's bases and
    filterbank in the order its ``mma.sync.m16n8k16`` B fragments read them
    (``csrc/mel_power_dense.cu``). Values: ``dense_tables`` split into bf16
    (hi, lo) pairs (``exact``) or rounded to bf16, the rows of C and S
    zero-padded to a multiple of ``DENSE_KC`` and the frequencies to a
    multiple of 16.

    ``basis_frag`` holds the frequency tiles of ``DENSE_FT`` bins in order
    (the last holds what is left, G groups of 8 bins), each
    [K/16, G, parts, 32 lanes, 4 words]: lane 4g + c holds bin 8j + g of
    group j — words 0, 1 of C's fragment, then 2, 3 of S's — so a thread's
    accumulators hold the real and imaginary parts of the same bins; parts
    are (hi, lo) or (hi,). ``fb_frag`` [n_freq_pad/16, ceil(n_mels/8), 32,
    2 * parts]: the filterbank's fragments, hi words then lo words, the mel
    columns zero-padded to a multiple of 8."""
    C, S, FB = _dense_split_tables(sr, n_fft, n_mels, fmin, fmax, exact)
    n_freq_pad = -(-(n_fft // 2 + 1) // 16) * 16
    k_pad = -(-n_fft // DENSE_KC) * DENSE_KC

    def frags(m, n_cols, pad_rows=0):
        m = F.pad(m.float()[:, :n_cols], (0, 0, 0, pad_rows)).to(torch.bfloat16)
        return _mma_b_fragments(m, range(0, n_cols, 8))

    # [K/16, groups, parts, 32, 4]
    parts = [torch.cat([frags(c, n_freq_pad, k_pad - n_fft), frags(s, n_freq_pad, k_pad - n_fft)], -1)
             for c, s in zip(C, S)]
    basis = torch.stack(parts, 2)
    tiles = [basis[:, j : j + DENSE_FT // 8].reshape(-1) for j in range(0, basis.shape[1], DENSE_FT // 8)]
    n_tiles = -(-n_mels // 8)
    fb = torch.cat([frags(F.pad(f.float()[:n_freq_pad], (0, 8 * n_tiles - n_mels)).to(torch.bfloat16),
                          8 * n_tiles) for f in FB], -1)
    return torch.cat(tiles).contiguous(), fb.contiguous()


def _tables(cfg: MelConfig, device: torch.device, algorithm: str = "ct", exact: bool = True):
    """The kernel's tables on ``device`` — ct: (C, S, FBM, win, wr) and dense:
    (C, S, FB) as f32 tensors, C/S/FBM/FB holding bf16 values with
    ``exact=False``; "ct_cat": (rhs_real, rhs_cplx, fbcat, win, wr) of
    ``ct_tables_folded_cat`` as f32 tensors; "ct_frag": (rhs_frag, fb_frag,
    win, wr), the int32 fragment tables of the concatenated-operand kernel;
    "ct_split_frag": (rhs_frag, fb_frag, win, wr) of
    ``ct_split_fragment_tables``; "dense_frag": (basis_frag, fb_frag) of
    ``dense_fragment_tables``."""
    return _device_tables(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, str(device), algorithm, exact)


@functools.lru_cache(maxsize=16)
def _device_tables(sr, n_fft, n_mels, fmin, fmax, device: str, algorithm: str, exact: bool):
    args = (sr, n_fft, n_mels, fmin, fmax)
    if algorithm == "dense":
        mats = [torch.from_numpy(a) for a in dense_tables(*args)]
        if not exact:
            mats = [round_bf16(a) for a in mats]
        rest = []
    elif algorithm == "dense_frag":
        mats, rest = list(dense_fragment_tables(*args, exact)), []
    elif algorithm == "ct_split_frag":
        mats = list(ct_split_fragment_tables(*args, exact))
        rest = [torch.from_numpy(ct_tables_folded(*args)[3]), torch.from_numpy(inner_weights(n_fft // 128))]
    elif algorithm in ("ct_cat", "ct_frag"):
        win, *cat = ct_tables_folded_cat(*args, exact)
        mats = [t.float() for t in cat] if algorithm == "ct_cat" else list(ct_fragment_tables(*args, exact))
        rest = [torch.from_numpy(win), torch.from_numpy(inner_weights(n_fft // 128))]
    else:
        *mats, win = ct_tables_folded(*args)
        mats = [torch.from_numpy(a) for a in mats] if exact else [t.float() for t in ct_tables_bf16(*args)]
        rest = [torch.from_numpy(win), torch.from_numpy(inner_weights(n_fft // 128))]
    return tuple(t.to(device) for t in mats + rest)


def apply_rms_scale(y: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    """The fused-RMS contract on [B, L] rows: s > 0 -> clip(y·s, −1, 1),
    s <= 0 (the silence sentinel) -> raw; ``scale=None`` -> y."""
    if scale is None:
        return y
    s = scale[:, None]
    return torch.where(s > 0, torch.clamp(y * s, -1.0, 1.0), y)


ABLATE_CLASSES = ("window", "inner", "power", "fb", "splits", "dots")  # bit i of the kernel's mask
EXACT_ONLY_CLASSES = ("splits", "dots")  # the classes of the exact mode's 3-pass split


def ablate_mask(ablate: tuple, *, exact: bool = True) -> int:
    """The kernel's bit mask of an ``ablate`` tuple (profiling only: the
    output is wrong by design). Wired, with the reference's meaning:
    'window' (no Hann multiply), 'inner' (the inner stage hands block r as
    a_re and block (r+1) % R as a_im), 'power' (p = x_re + x_im, both kept
    live), 'fb' (the first n_mels power columns stand for the filterbank
    product), and in the exact mode 'splits' (every bf16 split's lo = -hi, a
    distinct value, so no pass is removed) and 'dots' (one pass per logical
    product: a_hi·T_hi, and p_hi·F_hi for the filterbank). Refused, because a
    silent no-op would fake evidence: 'splits' and 'dots' in the bf16 mode
    (one pass, nothing split: the reference refuses them too) and 'shifts'
    (the misaligned sublane shift it isolates has no counterpart where a
    frame is read at any sample offset)."""
    mask = 0
    for cls in ablate:
        if cls in EXACT_ONLY_CLASSES and not exact:
            raise ValueError(
                f"ablate class {cls!r} only exists in an exact (3-pass bf16-split) outer "
                "stage; the bf16 kernel has no split/multi-pass arithmetic to remove"
            )
        if cls == "shifts":
            raise ValueError(
                "ablate class 'shifts' is not wired: a frame is read at any sample offset "
                "here, so there is no misaligned shift to remove"
            )
        if cls not in ABLATE_CLASSES:
            raise ValueError(f"unknown ablate class {cls!r}; wired: {ABLATE_CLASSES}")
        mask |= 1 << ABLATE_CLASSES.index(cls)
    return mask


def ablate_library(mask: int) -> str:
    """The library that holds the ablated instantiations of ``mask`` (both
    modes, or the exact one for a mask with 'splits' or 'dots'), built from
    the ct source the first time the mask is asked for."""
    return f"mel_power_ct_ablate{mask}"


def _ct_blocks(y_padded, scale, cfg: MelConfig, num_frames: int, first_frame: int, win: torch.Tensor):
    """Scaled, clipped and windowed frames as [B, T, R, 128] blocks in
    ``win``'s dtype."""
    frames = frames_of_padded(apply_rms_scale(y_padded, scale), n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                              num_frames=num_frames, first_frame=first_frame)
    frames = frames.to(win.dtype) * win
    return frames.reshape(frames.shape[0], num_frames, cfg.n_fft // 128, 128)


def _inner_stage(blocks: torch.Tensor, R: int, r: int, ablated: bool = False):
    """(a_re, a_im) of block r: the literal-weight R-point DFT over the
    128-sample blocks, zero terms skipped; a_im is None where it is exactly
    zero (r = 0 and r = R/2). ``ablated``: the reference's trivial provider,
    distinct operands per r with the same None pattern."""
    if ablated:
        return blocks[:, :, r], (None if (r == 0 or 2 * r == R) else blocks[:, :, (r + 1) % R])
    wr64 = inner_weights(R)
    a_re = a_im = None
    for n1 in range(R):
        j = (n1 * r) % R
        cw, sw = float(wr64[j, 0]), -float(wr64[j, 1])
        blk = blocks[:, :, n1]
        if cw != 0.0:
            a_re = blk * cw if a_re is None else a_re + blk * cw
        if sw != 0.0:
            a_im = blk * sw if a_im is None else a_im + blk * sw
    return a_re, a_im


def mel_power_ct_plain(
    y_padded: torch.Tensor,
    scale: torch.Tensor | None,
    cfg: MelConfig,
    num_frames: int,
    *,
    first_frame: int = 0,
    exact: bool = True,
    sums: torch.dtype = torch.float32,
    ablate: tuple = (),
) -> torch.Tensor:
    """Plain PyTorch version of the Cooley–Tukey kernel: [B, L] centre-padded
    rows (frame t starts at sample t·hop) -> mel power [B, num_frames,
    n_mels] of frames first_frame... Same scale and clip, Hann window,
    literal-weight R-point inner DFT over the 128-sample blocks (r <= R/2),
    per-r f32 products against the folded C/S tables, power, merged
    filterbank. ``exact=False`` is the bf16 mode: the inner-stage planes and
    the power are rounded to bf16 and the tables are their bf16 ``hi``
    halves; products and sums stay f32 (the reference's rounding points).
    ``sums=torch.float64`` takes every product and sum after the scale in
    f64, rounding points unchanged: the value that any order of f32 sums
    approximates, for telling a summation-order difference from a fault.
    ``ablate``: the classes of :func:`ablate_mask` but 'splits' and 'dots',
    dropped as the ablated kernel drops them (wrong output by design); this
    exact mode has no split (:func:`mel_power_ct_split_plain` has)."""
    R = cfg.n_fft // 128
    mask = ablate_mask(ablate, exact=exact)
    if mask >> 4:
        raise ValueError("ablate classes 'splits' and 'dots' belong to the split arithmetic: "
                         "use mel_power_ct_split_plain")
    no_window, no_inner, no_power, no_fb = (bool(mask >> i & 1) for i in range(4))
    C, S, FBM, win, _ = (t.to(sums) for t in _tables(cfg, y_padded.device, "ct", exact))
    rnd = (lambda x: x) if exact else (lambda x: round_bf16(x).to(sums))
    blocks = _ct_blocks(y_padded, scale, cfg, num_frames, first_frame, torch.ones_like(win) if no_window else win)
    acc = None
    with exact_f32():
        for r in range(R // 2 + 1):
            a_re, a_im = _inner_stage(blocks, R, r, no_inner)
            sl = slice(r * 128, (r + 1) * 128)
            a_re = rnd(a_re)
            x_re = a_re @ C[sl]
            x_im = -(a_re @ S[sl])
            if a_im is not None:
                a_im = rnd(a_im)
                x_re = x_re + a_im @ S[sl]
                x_im = x_im + a_im @ C[sl]
            p = x_re + x_im if no_power else x_re * x_re + x_im * x_im
            contrib = p[..., : cfg.n_mels] if no_fb else rnd(p) @ FBM[sl]
            acc = contrib if acc is None else acc + contrib
    return acc.float()


def mel_power_ct_split_plain(
    y_padded: torch.Tensor,
    scale: torch.Tensor | None,
    cfg: MelConfig,
    num_frames: int,
    *,
    first_frame: int = 0,
    exact: bool = True,
    sums: torch.dtype = torch.float32,
    ablate: tuple = (),
) -> torch.Tensor:
    """Plain PyTorch version of the Cooley–Tukey kernel's arithmetic
    (``csrc/mel_power_ct.cu``), the reference's ``_ct_outer_stage``. Exact:
    the inner planes and the tables are split into bf16 (hi, lo) pairs and
    every product is ``dot3h`` = (hi·hi + hi·lo) + lo·hi, so x_re = a_re·C
    (+ a_im·S) and x_im = −a_re·S (+ a_im·C); the f32 power is split again
    and contrib = (p_hi·F_hi + p_hi·F_lo) + p_lo·F_hi. ``exact=False`` is
    :func:`mel_power_ct_plain` ``(exact=False)``: one pass over the bf16
    operands. Every product is of two bf16 values and exact; the sums are
    f32, or f64 with ``sums=torch.float64`` (rounding points unchanged).
    ``ablate``: every class of :func:`ablate_mask`, as the reference drops
    it ('splits': lo = −hi; 'dots': hi·hi alone, p_hi·F_hi for the
    filterbank)."""
    if not exact:
        return mel_power_ct_plain(y_padded, scale, cfg, num_frames, first_frame=first_frame, exact=False,
                                  sums=sums, ablate=ablate)
    R = cfg.n_fft // 128
    mask = ablate_mask(ablate, exact=True)
    no_window, no_inner, no_power, no_fb, splits, dots = (bool(mask >> i & 1) for i in range(6))
    C, S, FBM, win, _ = _tables(cfg, y_padded.device, "ct", True)
    (Chi, Clo), (Shi, Slo), (Fhi, Flo) = (tuple(t.to(sums) for t in _split_bf16(m)) for m in (C, S, FBM))
    win = win.to(sums)
    blocks = _ct_blocks(y_padded, scale, cfg, num_frames, first_frame, torch.ones_like(win) if no_window else win)

    def split(x):  # (hi, lo), or (hi, -hi) with 'splits'
        hi, lo = _split_bf16(x)
        return (hi, -hi) if splits else (hi, lo)

    def dot3h(a, b_hi, b_lo):
        return a[0] @ b_hi if dots else (a[0] @ b_hi + a[0] @ b_lo) + a[1] @ b_hi

    acc = None
    with exact_f32():
        for r in range(R // 2 + 1):
            a_re, a_im = _inner_stage(blocks, R, r, no_inner)
            sl = slice(r * 128, (r + 1) * 128)
            ar = split(a_re)
            x_re = dot3h(ar, Chi[sl], Clo[sl])
            x_im = -dot3h(ar, Shi[sl], Slo[sl])
            if a_im is not None:
                ai = split(a_im)
                x_re = x_re + dot3h(ai, Shi[sl], Slo[sl])
                x_im = x_im + dot3h(ai, Chi[sl], Clo[sl])
            p = x_re + x_im if no_power else x_re * x_re + x_im * x_im
            if no_fb:
                contrib = p[..., : cfg.n_mels]
            elif dots:
                contrib = split(p)[0] @ Fhi[sl]
            else:
                p_hi, p_lo = split(p)
                contrib = (p_hi @ Fhi[sl] + p_hi @ Flo[sl]) + p_lo @ Fhi[sl]
            acc = contrib if acc is None else acc + contrib
    return acc.float()


def mel_power_ct_fused_plain(
    y_padded: torch.Tensor,
    scale: torch.Tensor | None,
    cfg: MelConfig,
    num_frames: int,
    *,
    first_frame: int = 0,
    exact: bool = True,
    sums: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of the concatenated-operand kernel
    (``fused_dots=True``), after the reference's ``_ct_outer_stage_fused``:
    the inner planes are split into bf16 hi/lo pairs and each r is one
    product ``[ar_hi ar_hi ar_lo (ai_hi ai_hi ai_lo)] @ RHS_r -> x_re | x_im``
    against the tables of :func:`ct_tables_folded_cat`; the f32 power is
    split again and ``[p_hi p_hi p_lo] @ FBCAT_r`` accumulates the mels.
    ``exact=False``: ``[bf16(a_re) bf16(a_im)] @ RHS_r`` and ``bf16(p) @ F_hi``.
    Every operand is a bf16 value held in f32, so every product is exact;
    the sums are f32, or f64 with ``sums=torch.float64`` (rounding points
    unchanged)."""
    R = cfg.n_fft // 128
    K1 = 384 if exact else 128
    rhs_real, rhs_cplx, fbcat, win, _ = (t.to(sums) for t in _tables(cfg, y_padded.device, "ct_cat", exact))
    blocks = _ct_blocks(y_padded, scale, cfg, num_frames, first_frame, win)

    def operand(a):  # [a_hi a_hi a_lo], or bf16(a) in the bf16 mode
        hi, lo = _split_bf16(a)
        return [hi, hi, lo] if exact else [hi]

    idx_real = idx_cplx = 0
    acc = None
    with exact_f32():
        for r in range(R // 2 + 1):
            a_re, a_im = _inner_stage(blocks, R, r)
            if a_im is None:
                x = torch.cat(operand(a_re), -1) @ rhs_real[idx_real * K1 : (idx_real + 1) * K1]
                idx_real += 1
            else:
                x = torch.cat(operand(a_re) + operand(a_im), -1) @ rhs_cplx[idx_cplx * 2 * K1 : (idx_cplx + 1) * 2 * K1]
                idx_cplx += 1
            x_re, x_im = x[..., :128], x[..., 128:]
            p = x_re * x_re + x_im * x_im
            contrib = torch.cat(operand(p), -1) @ fbcat[r * K1 : (r + 1) * K1]
            acc = contrib if acc is None else acc + contrib
    return acc.float()


def mel_power_dense_plain(
    y_padded: torch.Tensor,
    scale: torch.Tensor | None,
    cfg: MelConfig,
    num_frames: int,
    *,
    first_frame: int = 0,
    exact: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of the dense kernel: frames against the
    windowed DFT bases, power, filterbank, all f32. ``exact=False`` rounds
    the frames, the bases, the power and the filterbank to bf16 (the
    reference kernel's DEFAULT precision on the TPU); sums stay f32."""
    C, S, FB = _tables(cfg, y_padded.device, "dense", exact)
    rnd = (lambda x: x) if exact else round_bf16
    frames = frames_of_padded(rnd(apply_rms_scale(y_padded, scale)), n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                              num_frames=num_frames, first_frame=first_frame)
    with exact_f32():
        re = frames @ C
        im = frames @ S
        return rnd(re * re + im * im) @ FB


def mel_power_dense_split_plain(
    y_padded: torch.Tensor,
    scale: torch.Tensor | None,
    cfg: MelConfig,
    num_frames: int,
    *,
    first_frame: int = 0,
    exact: bool = True,
    sums: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of the dense kernel's arithmetic
    (``csrc/mel_power_dense.cu``). ``exact``: the scaled frames and the
    bases are split into bf16 (hi, lo) pairs and re | im = f_hi·C_hi +
    f_hi·C_lo + f_lo·C_hi (passes in that order, as one product over the
    operands stacked along K); the f32 power is split again and
    mel = p_hi·F_hi + p_hi·F_lo + p_lo·F_hi. ``exact=False``: one pass over
    bf16(frames), the bf16 bases, bf16(p) and the bf16 filterbank, the
    rounding points of :func:`mel_power_dense_plain` ``(exact=False)``. Every
    product is of two bf16 values and exact in f32; the sums are f32, or f64
    with ``sums=torch.float64`` (rounding points unchanged)."""
    C, S, FB = (tuple(t.to(y_padded.device, sums) for t in m)
                for m in _dense_split_tables(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, exact))
    frames = frames_of_padded(apply_rms_scale(y_padded, scale), n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                              num_frames=num_frames, first_frame=first_frame)

    def operand(a):  # [a_hi a_hi a_lo], or bf16(a) in the bf16 mode
        hi, lo = (t.to(sums) for t in _split_bf16(a))
        return torch.cat([hi, hi, lo] if exact else [hi], -1)

    def stack(m):  # (m_hi; m_lo; m_hi) along K, or m_hi
        return torch.cat([m[0], m[1], m[0]] if exact else [m[0]], 0)

    with exact_f32():
        f = operand(frames)
        re, im = f @ stack(C), f @ stack(S)
        return (operand(re * re + im * im) @ stack(FB)).float()


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    """A kernel library, built at first use, with its C signatures bound."""
    from anuraxla_torch.ops import _build

    lib = _build.load(name)
    source = _build.source_of(name)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch = getattr(lib, f"{source}_launch")
    launch.argtypes = {
        # y, L, scale, rhs_frag, fb_frag, win, wr, out, B, T, frame0, pad_l, n_fft, hop, n_mels, tf, bf16,
        # ablate, stream
        "mel_power_ct": [vp, i64, vp, vp, vp, vp, vp, vp, *[i32] * 10, vp],
        # y, L, scale, rhs_frag, fb_frag, win, wr, out, B, T, frame0, pad_l, n_fft, hop, n_mels, bf16, stream
        "mel_power_ct_split": [vp, i64, vp, vp, vp, vp, vp, vp, *[i32] * 8, vp],
        # y, L, scale, basis_frag, fb_frag, out, B, T, frame0, pad_l, n_fft, hop, n_mels, tf, ksteps,
        # stages, bf16, stream
        "mel_power_dense": [vp, i64, vp, vp, vp, vp, *[i32] * 11, vp],
    }[source]
    launch.restype = i32
    smem = getattr(lib, f"{source}_smem_bytes")
    smem.argtypes = [i32] * {"mel_power_dense": 6, "mel_power_ct": 4}.get(source, 2)
    smem.restype = i64
    return lib


SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block can use
# the dense kernel's (frames a block, k16 steps a ring buffer, ring buffers),
# in the order it prefers them: the most frames a block (each base tile comes
# from L2 once for all of them) with the wide ring, then fewer frames, and
# last a small ring that keeps a long audio window within shared memory
DENSE_TILES = ((128, 4, 3), (64, 4, 3), (32, 4, 3), (16, 4, 3), (16, 1, 2))


def dense_smem_bytes(n_fft: int, hop: int, tile: tuple, exact: bool) -> int:
    """Shared memory (bytes) of the dense kernel with ``tile``: the ring of
    fragment buffers and the bf16 audio planes (hi and lo with ``exact``) of
    (frames - 1)·hop + n_fft samples, n_fft rounded up to ``DENSE_KC``; the
    host's copy of ``mel_power_dense_smem_bytes``."""
    tf, ksteps, stages = tile
    parts = 2 if exact else 1
    n_aud = (tf - 1) * hop + -(-n_fft // DENSE_KC) * DENSE_KC
    return stages * ksteps * (DENSE_FT // 8) * parts * 512 + parts * 2 * (-(-n_aud // 8) * 8)


def dense_tile(n_fft: int, hop: int, exact: bool) -> tuple | None:
    """The first of ``DENSE_TILES`` whose shared memory fits a block, or None."""
    return next((t for t in DENSE_TILES if dense_smem_bytes(n_fft, hop, t, exact) <= SMEM_LIMIT), None)


# the Cooley–Tukey kernel's frames a block, in the order it prefers them: each
# table fragment comes from L2 once for all of a block's frames
CT_TILES = (64, 32, 16)
CT_LDA = 136  # bf16 a plane row of the ct kernel (128 + 8: conflict-free ldmatrix)


def ct_smem_bytes(n_fft: int, hop: int, tf: int, exact: bool) -> int:
    """Shared memory (bytes) of the Cooley–Tukey kernel with ``tf`` frames a
    block: a ring of three buffers of table fragments (one k16 step of C and S
    hi/lo, or two of the bf16 halves: 48 KB either way), then the f32 window
    of (tf - 1)·hop + n_fft samples and two [tf][136] bf16 planes (hi and lo
    with ``exact``), which at the end hold the q parts' mel values ([128][136]
    f32 at most); the host's copy of ``mel_power_ct_smem_bytes``."""
    parts = 2 if exact else 1
    ring = 3 * (1 if exact else 2) * 16 * parts * 512
    n_aud = (tf - 1) * hop + n_fft
    work = -(-n_aud // 4) * 16 + 2 * parts * tf * CT_LDA * 2
    return ring + max(work, 128 * CT_LDA * 4)


def ct_tile(n_fft: int, hop: int, exact: bool) -> int | None:
    """The first of ``CT_TILES`` whose shared memory fits a block, or None."""
    return next((t for t in CT_TILES if ct_smem_bytes(n_fft, hop, t, exact) <= SMEM_LIMIT), None)


def mel_power(
    y: torch.Tensor,
    cfg: MelConfig,
    *,
    num_frames: int,
    first_frame: int = 0,
    rms_scale: torch.Tensor | None = None,
    pre_padded: bool = False,
    exact: bool = True,
    algorithm: str = "auto",
    fused_dots: bool = False,
    ablate: tuple = (),
) -> torch.Tensor:
    """[B, L] f32 waveforms -> mel power [B, num_frames, n_mels] f32 of the
    centred frames first_frame .. first_frame + num_frames − 1.

    ``exact``: the exact tier — f32 arithmetic, or the bf16×3 split on the
    tensor cores (the dense kernel, ``fused_dots``), within 2e-5 of a row's
    max from it; False is the bf16 mode (one bf16 pass per product, f32
    sums). ``algorithm``: "ct" (Cooley–Tukey, n_fft a >= 2
    multiple of 128 and hop % 32 == 0), "dense" (windowed-DFT bases,
    hop % 16 == 0) or "auto" (ct where it can). ``first_frame``: the
    crop-first frontend computes only the frames that survive its crop.
    ``pre_padded``: rows are already in :func:`phase_padded_layout` for
    first_frame + num_frames frames (ct with hop % 128 == 0 only);
    otherwise they are [B, num_samples], centred by n_fft//2.
    ``rms_scale`` [B]: rows with s > 0 are clip(y·s, −1, 1)'d before the
    window, rows with s <= 0 pass through raw.
    ``fused_dots`` (ct only; the kernel study's variant): the outer stage as
    one product per r over concatenated bf16 hi/lo split operands on the
    tensor cores.
    ``ablate`` (PROFILING ONLY — wrong output): classes of
    :func:`ablate_mask` dropped from the ct kernel at hop % 128 == 0, for
    ``probes/kernel_ablation.py``.

    A CUDA tensor goes to a Hopper kernel, or this raises; a CPU tensor goes
    to the kernel's plain version (an ablated exact call to
    :func:`mel_power_ct_split_plain`, the arithmetic of the instantiations it
    profiles; an intact exact call to plain f32).
    """
    if y.ndim != 2:
        raise ValueError(f"expected [B, L] rows, got shape {tuple(y.shape)}")
    if num_frames < 1 or first_frame < 0:
        raise ValueError(f"need num_frames >= 1 and first_frame >= 0, got {num_frames}, {first_frame}")
    algorithm = resolve_algorithm(cfg, algorithm)
    if fused_dots and algorithm != "ct":
        raise ValueError("fused_dots is a variant of the ct kernel; it needs algorithm 'ct'")
    mask = 0
    if ablate:
        if algorithm != "ct" or cfg.hop_length % 128 != 0:
            raise ValueError("ablate (profiling only) is wired only into the ct kernel at hop % 128 == 0")
        if fused_dots:
            raise ValueError(
                "ablate is not wired into the fused-dots outer stage — drop fused_dots for profiling runs"
            )
        mask = ablate_mask(tuple(ablate), exact=exact)
    pad_l = cfg.n_fft // 2
    if pre_padded:
        if algorithm != "ct" or cfg.hop_length % 128 != 0:
            raise ValueError(
                "pre_padded=True requires the ct kernel at hop % 128 == 0 (the "
                "phase_padded_layout) — slice the valid region out for other "
                "paths (log_mel_batch does this on the matmul backends)"
            )
        L_pad, _ = phase_padded_layout(cfg, first_frame + num_frames)
        if y.shape[1] != L_pad:
            raise ValueError(
                f"pre_padded input must be the phase_padded_layout length {L_pad} "
                f"for num_frames={first_frame + num_frames}, got {y.shape[1]}"
            )
        pad_l = 0
    if rms_scale is not None and rms_scale.shape != (y.shape[0],):
        raise ValueError(f"rms_scale must be [{y.shape[0]}], got {tuple(rms_scale.shape)}")

    if y.device.type == "cpu":
        rows = F.pad(y, (pad_l, pad_l))
        if algorithm == "dense":
            return mel_power_dense_plain(rows, rms_scale, cfg, num_frames, first_frame=first_frame, exact=exact)
        if fused_dots:
            return mel_power_ct_fused_plain(rows, rms_scale, cfg, num_frames, first_frame=first_frame, exact=exact)
        plain = mel_power_ct_split_plain if exact and ablate else mel_power_ct_plain
        return plain(rows, rms_scale, cfg, num_frames, first_frame=first_frame, exact=exact, ablate=tuple(ablate))
    if y.device.type != "cuda":
        raise ValueError(f"mel_power runs on cuda or cpu tensors, got {y.device}")
    if not pre_padded:
        y = y.contiguous()
    if y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError("mel_power needs contiguous float32 rows")
    if rms_scale is not None and (
        rms_scale.device != y.device or rms_scale.dtype != torch.float32
        or not rms_scale.is_contiguous()
    ):
        raise ValueError("rms_scale must be a contiguous float32 tensor on the rows' device")
    B, L = y.shape
    if B > 65535:
        raise ValueError(f"at most 65535 rows per launch, got {B}")
    source = "mel_power_dense" if algorithm == "dense" else "mel_power_ct_split" if fused_dots else "mel_power_ct"
    # ablated instantiations live in libraries of their own: the serving library holds none
    lib = _lib(ablate_library(mask) if mask else source)
    shape = [cfg.n_fft, cfg.hop_length, cfg.n_mels]
    if algorithm == "dense":
        tile = dense_tile(cfg.n_fft, cfg.hop_length, exact)
        if tile is None:
            raise NotImplementedError(
                f"n_fft={cfg.n_fft}, hop={cfg.hop_length} needs "
                f"{dense_smem_bytes(cfg.n_fft, cfg.hop_length, DENSE_TILES[-1], exact)} B of shared memory"
            )
        shape += tile
    elif not fused_dots:
        tf = ct_tile(cfg.n_fft, cfg.hop_length, exact)
        if tf is None:
            raise NotImplementedError(
                f"n_fft={cfg.n_fft}, hop={cfg.hop_length} needs "
                f"{ct_smem_bytes(cfg.n_fft, cfg.hop_length, CT_TILES[-1], exact)} B of shared memory"
            )
        shape.append(tf)
    else:
        smem = getattr(lib, f"{source}_smem_bytes")(cfg.n_fft, cfg.hop_length)
        if smem > SMEM_LIMIT:
            raise NotImplementedError(
                f"n_fft={cfg.n_fft}, hop={cfg.hop_length} needs {smem} B of shared memory"
            )
    kind = "ct_frag" if fused_dots else "dense_frag" if algorithm == "dense" else "ct_split_frag"
    tables = _tables(cfg, y.device, kind, exact)
    out = torch.empty((B, num_frames, cfg.n_mels), device=y.device, dtype=torch.float32)
    mode = [int(not exact)] + ([mask] if source == "mel_power_ct" else [])
    with torch.cuda.device(y.device):
        err = getattr(lib, f"{source}_launch")(
            y.data_ptr(), L, rms_scale.data_ptr() if rms_scale is not None else None,
            *(t.data_ptr() for t in tables), out.data_ptr(),
            B, num_frames, first_frame, pad_l, *shape, *mode,
            torch.cuda.current_stream(y.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{source} launch failed: cudaError_t {err}")
    mel_power.launches[kernel_name(cfg, algorithm, exact, fused_dots)] += 1
    return out


KERNEL_NAMES = ("mel_power_ct", "mel_power_ct_hop32", "mel_power_ct_bf16",
                "mel_power_dense", "mel_power_dense_bf16",
                "mel_power_ct_fused", "mel_power_ct_fused_bf16")
# launches by kernel and mode; a wrapper adds one where it launches, nowhere else
mel_power.launches = dict.fromkeys(KERNEL_NAMES, 0)


def reset_launches() -> None:
    for name in KERNEL_NAMES:
        mel_power.launches[name] = 0
