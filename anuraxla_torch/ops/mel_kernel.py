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
- ``mel_power_ct_plain`` / ``mel_power_dense_plain``: the plain PyTorch
  versions of the kernels' math, exact and bf16.
- ``mel_power``: the wrapper. On a CUDA tensor it launches a hand-written
  Hopper kernel (``csrc/mel_power_ct.cu`` or ``csrc/mel_power_dense.cu``) or
  raises; it takes a plain version only for a tensor on the CPU.
  ``mel_power.launches`` counts the kernel launches by kernel and mode.

Which kernel runs (``kernel_name``):

=====================  =========  =====  ==================================
name                   algorithm  exact  config
=====================  =========  =====  ==================================
``mel_power_ct``       ct         yes    n_fft % 128 == 0, hop % 128 == 0
``mel_power_ct_hop32`` ct         yes    n_fft % 128 == 0, hop % 32 == 0
``mel_power_ct_bf16``  ct         no     n_fft % 128 == 0, hop % 32 == 0
``mel_power_dense``    dense      yes    hop % 16 == 0
``mel_power_dense_bf16`` dense    no     hop % 16 == 0
=====================  =========  =====  ==================================

The first three are one source (``mel_power_ct.cu``): on this card a frame
is read at any sample offset, so the reference's separate kernel for
hop % 128 != 0 needs no code of its own.
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


def kernel_name(cfg: MelConfig, algorithm: str, exact: bool) -> str:
    """The launch counter's key for a resolved algorithm (module docstring)."""
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


def _tables(cfg: MelConfig, device: torch.device, algorithm: str = "ct", exact: bool = True):
    """The kernel's tables as f32 tensors on ``device`` — ct: (C, S, FBM, win,
    wr); dense: (C, S, FB). With ``exact=False`` C/S/FBM/FB hold bf16 values."""
    return _device_tables(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, str(device), algorithm, exact)


@functools.lru_cache(maxsize=16)
def _device_tables(sr, n_fft, n_mels, fmin, fmax, device: str, algorithm: str, exact: bool):
    args = (sr, n_fft, n_mels, fmin, fmax)
    if algorithm == "dense":
        mats = [torch.from_numpy(a) for a in dense_tables(*args)]
        if not exact:
            mats = [round_bf16(a) for a in mats]
        rest = []
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


def mel_power_ct_plain(
    y_padded: torch.Tensor,
    scale: torch.Tensor | None,
    cfg: MelConfig,
    num_frames: int,
    *,
    first_frame: int = 0,
    exact: bool = True,
    sums: torch.dtype = torch.float32,
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
    approximates, for telling a summation-order difference from a fault."""
    R = cfg.n_fft // 128
    C, S, FBM, win, _ = (t.to(sums) for t in _tables(cfg, y_padded.device, "ct", exact))
    rnd = (lambda x: x) if exact else (lambda x: round_bf16(x).to(sums))
    frames = frames_of_padded(apply_rms_scale(y_padded, scale), n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                              num_frames=num_frames, first_frame=first_frame).to(sums) * win
    blocks = frames.reshape(frames.shape[0], num_frames, R, 128)
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
            a_re = rnd(a_re)
            x_re = a_re @ C[sl]
            x_im = -(a_re @ S[sl])
            if a_im is not None:
                a_im = rnd(a_im)
                x_re = x_re + a_im @ S[sl]
                x_im = x_im + a_im @ C[sl]
            p = rnd(x_re * x_re + x_im * x_im)
            contrib = p @ FBM[sl]
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


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    """A kernel library, built at first use, with its C signatures bound."""
    from anuraxla_torch.ops import _build

    lib = _build.load(name)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch = getattr(lib, f"{name}_launch")
    if name == "mel_power_ct":
        # y, L, scale, C, S, FBM, win, wr, out, B, T, frame0, pad_l, n_fft, hop, n_mels, bf16, stream
        launch.argtypes = [vp, i64, vp, vp, vp, vp, vp, vp, vp, *[i32] * 8, vp]
    else:
        # y, L, scale, C, S, FB, out, B, T, frame0, pad_l, n_fft, hop, n_mels, n_freq_pad, bf16, stream
        launch.argtypes = [vp, i64, vp, vp, vp, vp, vp, *[i32] * 9, vp]
    launch.restype = i32
    smem = getattr(lib, f"{name}_smem_bytes")
    smem.argtypes = [i32, i32]
    smem.restype = i64
    return lib


SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block can use


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
) -> torch.Tensor:
    """[B, L] f32 waveforms -> mel power [B, num_frames, n_mels] f32 of the
    centred frames first_frame .. first_frame + num_frames − 1.

    ``exact``: full-f32 arithmetic; False is the bf16 mode (one bf16 pass per
    product, f32 sums). ``algorithm``: "ct" (Cooley–Tukey, n_fft a >= 2
    multiple of 128 and hop % 32 == 0), "dense" (windowed-DFT bases,
    hop % 16 == 0) or "auto" (ct where it can). ``first_frame``: the
    crop-first frontend computes only the frames that survive its crop.
    ``pre_padded``: rows are already in :func:`phase_padded_layout` for
    first_frame + num_frames frames (ct with hop % 128 == 0 only);
    otherwise they are [B, num_samples], centred by n_fft//2.
    ``rms_scale`` [B]: rows with s > 0 are clip(y·s, −1, 1)'d before the
    window, rows with s <= 0 pass through raw.

    A CUDA tensor goes to a Hopper kernel, or this raises; a CPU tensor goes
    to the kernel's plain version.
    """
    if y.ndim != 2:
        raise ValueError(f"expected [B, L] rows, got shape {tuple(y.shape)}")
    if num_frames < 1 or first_frame < 0:
        raise ValueError(f"need num_frames >= 1 and first_frame >= 0, got {num_frames}, {first_frame}")
    algorithm = resolve_algorithm(cfg, algorithm)
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
        plain = mel_power_ct_plain if algorithm == "ct" else mel_power_dense_plain
        return plain(F.pad(y, (pad_l, pad_l)), rms_scale, cfg, num_frames,
                     first_frame=first_frame, exact=exact)
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
    source = "mel_power_ct" if algorithm == "ct" else "mel_power_dense"
    lib = _lib(source)
    smem = getattr(lib, f"{source}_smem_bytes")(cfg.n_fft, cfg.hop_length)
    if smem > SMEM_LIMIT:
        raise NotImplementedError(
            f"n_fft={cfg.n_fft}, hop={cfg.hop_length} needs {smem} B of shared memory"
        )
    tables = _tables(cfg, y.device, algorithm, exact)
    out = torch.empty((B, num_frames, cfg.n_mels), device=y.device, dtype=torch.float32)
    shape = [cfg.n_fft, cfg.hop_length, cfg.n_mels]
    if algorithm == "dense":
        shape.append(tables[0].shape[1])  # n_freq_pad
    with torch.cuda.device(y.device):
        err = getattr(lib, f"{source}_launch")(
            y.data_ptr(), L, rms_scale.data_ptr() if rms_scale is not None else None,
            *(t.data_ptr() for t in tables), out.data_ptr(),
            B, num_frames, first_frame, pad_l, *shape, int(not exact),
            torch.cuda.current_stream(y.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{source} launch failed: cudaError_t {err}")
    mel_power.launches[kernel_name(cfg, algorithm, exact)] += 1
    return out


KERNEL_NAMES = ("mel_power_ct", "mel_power_ct_hop32", "mel_power_ct_bf16",
                "mel_power_dense", "mel_power_dense_bf16")
# launches by kernel and mode; a wrapper adds one where it launches, nowhere else
mel_power.launches = dict.fromkeys(KERNEL_NAMES, 0)


def reset_launches() -> None:
    for name in KERNEL_NAMES:
        mel_power.launches[name] = 0
