"""Fused mel power — the port of ``anuraxla/ops/pallas_frontend.py``'s
main-path kernel (``_mel_power_ctp_kernel``, exact mode).

- ``phase_padded_layout`` / ``kernel_supported``: copies of the reference's
  ``phase_padded_layout`` and ``pallas_supported`` (the same gate), so host
  decoders produce the rows the reference's kernel would read.
- ``ct_tables_folded``: the twiddle-folded Cooley–Tukey tables C/S, the
  merged filterbank FBM and the window, in float32 rounded from the same
  float64 construction as the reference's ``_ct_tables_folded`` (which
  splits them into bf16 hi/lo pairs for the TPU's matrix unit instead).
- ``mel_power_ct_plain``: the plain PyTorch version of the kernel's math.
- ``mel_power``: the wrapper. On a CUDA tensor it launches the hand-written
  Hopper kernel (``csrc/mel_power_ct.cu``) or raises; it takes the plain
  version only for a tensor on the CPU. ``mel_power.launches`` counts the
  kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from anuraxla_torch.constants import MelConfig
from anuraxla_torch.ops.mel import mel_filterbank
from anuraxla_torch.ops.stft import hann_window
from anuraxla_torch.utils.precision import exact_f32

TILE_T = 128  # the reference kernel's frame tile; fixes the padded row length
KERNEL = "mel_power_ct"


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
    >= 2 multiple of 128 and hop % 32 == 0; dense needs hop % 16 == 0. Kept
    as the copy that the tests hold to ``pallas_supported``; the port decides
    with :func:`kernel_takes`."""
    hop, n_fft = cfg.hop_length, cfg.n_fft
    ct_ok = n_fft % 128 == 0 and n_fft >= 256 and hop % 32 == 0
    dense_ok = (8 * hop) % 128 == 0
    if algorithm == "ct":
        return ct_ok
    if algorithm == "dense":
        return dense_ok
    return ct_ok or dense_ok


def kernel_takes(cfg: MelConfig) -> bool:
    """Whether the Hopper kernel computes this config: the ct family with
    hop % 128 == 0 (the reference's phase branch) and at most 128 mels."""
    return kernel_supported(cfg, "ct") and cfg.hop_length % 128 == 0 and cfg.n_mels <= 128


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


def _tables(cfg: MelConfig, device: torch.device):
    """(C, S, FBM, win, wr) as f32 tensors on ``device``."""
    return _device_tables(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, str(device))


@functools.lru_cache(maxsize=8)
def _device_tables(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float, device: str):
    C, S, FBM, win = ct_tables_folded(sr, n_fft, n_mels, fmin, fmax)
    return tuple(torch.from_numpy(a).to(device) for a in (C, S, FBM, win, inner_weights(n_fft // 128)))


def apply_rms_scale(y: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    """The fused-RMS contract on [B, L] rows: s > 0 -> clip(y·s, −1, 1),
    s <= 0 (the silence sentinel) -> raw; ``scale=None`` -> y."""
    if scale is None:
        return y
    s = scale[:, None]
    return torch.where(s > 0, torch.clamp(y * s, -1.0, 1.0), y)


def mel_power_ct_plain(
    y_padded: torch.Tensor,
    scale: torch.Tensor | None,
    cfg: MelConfig,
    num_frames: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B, L] rows whose frame t starts
    at sample t·hop (the pre-padded layout) -> mel power [B, num_frames,
    n_mels]. Same scale and clip, Hann window, literal-weight R-point inner
    DFT over the 128-sample blocks (r <= R/2), per-r f32 products against
    the folded C/S tables, power, merged filterbank."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    R = n_fft // 128
    C, S, FBM, win, wr = _tables(cfg, y_padded.device)
    y = apply_rms_scale(y_padded, scale)
    need = (num_frames - 1) * hop + n_fft
    if need > y.shape[1]:
        y = F.pad(y, (0, need - y.shape[1]))
    frames = y.unfold(-1, n_fft, hop)[:, :num_frames] * win  # [B, T, n_fft]
    blocks = frames.reshape(y.shape[0], num_frames, R, 128)
    wr64 = inner_weights(R)
    acc = None
    with exact_f32():
        for r in range(R // 2 + 1):
            a_re = a_im = None
            for n1 in range(R):
                j = (n1 * r) % R
                cw, sw = float(wr64[j, 0]), -float(wr64[j, 1])
                blk = blocks[:, :, n1]
                if cw != 0.0:
                    a_re = blk * cw if a_re is None else a_re + blk * cw
                if sw != 0.0:
                    a_im = blk * sw if a_im is None else a_im + blk * sw
            sl = slice(r * 128, (r + 1) * 128)
            x_re = a_re @ C[sl]
            x_im = -(a_re @ S[sl])
            if a_im is not None:
                x_re = x_re + a_im @ S[sl]
                x_im = x_im + a_im @ C[sl]
            p = x_re * x_re + x_im * x_im
            contrib = p @ FBM[sl]
            acc = contrib if acc is None else acc + contrib
    return acc


@functools.lru_cache(maxsize=1)
def _lib():
    """The kernel library, built at first use, with its C signatures bound."""
    from anuraxla_torch.ops import _build

    lib = _build.load(KERNEL)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mel_power_ct_launch.argtypes = [vp, i64, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
    lib.mel_power_ct_launch.restype = i32
    lib.mel_power_ct_smem_bytes.argtypes = [i32, i32]
    lib.mel_power_ct_smem_bytes.restype = i64
    return lib


SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block can use


def mel_power(
    y: torch.Tensor,
    cfg: MelConfig,
    *,
    num_frames: int,
    rms_scale: torch.Tensor | None = None,
    pre_padded: bool = False,
) -> torch.Tensor:
    """[B, L] f32 waveforms -> mel power [B, num_frames, n_mels] f32.

    ``pre_padded``: rows are already in :func:`phase_padded_layout`;
    otherwise they are [B, num_samples] and padded by n_fft//2 here.
    ``rms_scale`` [B]: rows with s > 0 are clip(y·s, −1, 1)'d before the
    window, rows with s <= 0 pass through raw.

    A CUDA tensor goes to the Hopper kernel, or this raises; a CPU tensor
    goes to :func:`mel_power_ct_plain`.
    """
    if y.ndim != 2:
        raise ValueError(f"expected [B, L] rows, got shape {tuple(y.shape)}")
    if not kernel_takes(cfg):
        raise NotImplementedError(
            f"the mel kernel needs n_fft a >= 2 multiple of 128, hop % 128 == 0 "
            f"and n_mels <= 128; got n_fft={cfg.n_fft}, hop={cfg.hop_length}, "
            f"n_mels={cfg.n_mels} (frontend backend 'matmul' takes it)"
        )
    L_pad, pad_l = phase_padded_layout(cfg, num_frames)
    if pre_padded and y.shape[1] != L_pad:
        raise ValueError(
            f"pre_padded input must be the phase_padded_layout length {L_pad} "
            f"for num_frames={num_frames}, got {y.shape[1]}"
        )
    if not pre_padded:
        y = F.pad(y, (pad_l, pad_l))
    if rms_scale is not None and rms_scale.shape != (y.shape[0],):
        raise ValueError(f"rms_scale must be [{y.shape[0]}], got {tuple(rms_scale.shape)}")

    if y.device.type == "cpu":
        return mel_power_ct_plain(y, rms_scale, cfg, num_frames)
    if y.device.type != "cuda":
        raise ValueError(f"mel_power runs on cuda or cpu tensors, got {y.device}")
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
    lib = _lib()
    smem = lib.mel_power_ct_smem_bytes(cfg.n_fft, cfg.hop_length)
    if smem > SMEM_LIMIT:
        raise NotImplementedError(
            f"n_fft={cfg.n_fft}, hop={cfg.hop_length} needs {smem} B of shared memory"
        )
    C, S, FBM, win, wr = _tables(cfg, y.device)
    out = torch.empty((B, num_frames, cfg.n_mels), device=y.device, dtype=torch.float32)
    with torch.cuda.device(y.device):
        err = lib.mel_power_ct_launch(
            y.data_ptr(), L, rms_scale.data_ptr() if rms_scale is not None else None,
            win.data_ptr(), C.data_ptr(), S.data_ptr(), FBM.data_ptr(), wr.data_ptr(),
            out.data_ptr(), B, num_frames, cfg.n_fft, cfg.hop_length, cfg.n_mels,
            torch.cuda.current_stream(y.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"mel_power_ct launch failed: cudaError_t {err}")
    mel_power.launches += 1
    return out


mel_power.launches = 0
