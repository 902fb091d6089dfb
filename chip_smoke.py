"""On-card smoke run of the PyTorch/CUDA port (``anuraxla_torch``).

    python3 chip_smoke.py [--seed 0] [--profile] [--dense-checkpoints [WHICH]]

Needs one CUDA card, ``nvcc`` and the checkout it sits in. Phases (any
failure exits non-zero):
1. build every Hopper kernel of ``anuraxla_torch/csrc`` (one nvcc each, all
   started together);
2. hold each serving kernel and mode against the plain PyTorch version of its
   arithmetic on the card, each row against its own max, with a silent and a
   clipping row: the Cooley-Tukey kernel exact (``DEFAULT_MEL``, R = 2), in
   its bf16 mode (full range and the fast tier's frame range), at hop 320 /
   160 / 96; the dense kernel exact and bf16 at hop 240 and at n_fft 400 / hop
   80; every exact case also against plain f32. Every case is also held to its
   plain version with f64 sums, to show where the differences come from;
3. drive the main paths — ``EncoderSession.encode_paths`` and
   ``detect_species`` on six WAVs — with the kernels' launch counts set to 0
   just before each and read just after: the parity and balanced tiers at
   ``DEFAULT_MEL`` (pre-padded host rows), the fast tier at ``DEFAULT_MEL``
   (crop-first frontend, bf16 kernel, bf16 trunk), the parity tier at hop 320
   and at hop 240, the fast tier at hop 240. f32 latents must match the same session on the CPU and the
   decisions must agree, and no serving path may launch the split kernel;
4. time ``encode_array`` (chunks/s, balanced and fast tier), each kernel, its
   plain version, its bound and one PyTorch library call computing the same
   function (the exact dense kernel at B = 256, the shape of earlier runs, and
   at B = 1024), with the frame tile each kernel took;
5. the fit path at full width (balanced tier): a synthetic tree of 4 species x
   48 WAVs and an encoder artifact written by ``save_encoder``;
   ``fit_radial_tree`` and ``fit_map_tree`` (LDA full; QDA diag, shrink 0.1)
   on the card, the species-tree cache read back, ``evaluate_wav`` and
   ``evaluate_wav_map`` served from the written config.json on six held-out
   WAVs, launch counts and decode routes set to 0 just before and read just
   after (``mel_power_ct`` and the native decoder must move, the Python
   reader must not); the same fits on the CPU from the card's latents held to
   the card's (centroids, rk, means 1e-5; logdets, tau 1e-4; decisions
   identical) and the CLIs' exit codes to the CPU fits' decisions; times of
   the fits and of ``encode_paths`` at B = 1024 over 4096 paths by three
   decode routes (the Python reader with a copy into the pinned slot, the
   native decoder into the slot, the same with ``transfer_int16``), each
   with one batch's decode, copy and transfer;
6. the evaluation path at full width (balanced tier, pre-padded rows) on the
   fit phase's project — its encoder artifact and the config.json it wrote —
   through the ``main`` of each CLI run from the project root, launch counts
   set to 0 just before each step and read just after (``mel_power_ct`` must
   move, the split kernel must not): ``benchmark-folder`` and
   ``benchmark-folder-map`` on a val tree of 4 species x 48 WAVs and one
   truncated WAV (one ERROR row, ``summary.txt`` parsed by
   ``spearman_analysis.parse_summary``, every decision equal to the same
   decision on the CPU from the card's latents), ``--snr-sweep clean,20,8``
   (its clean point equal to the benchmark), ``run-qout-grid`` in process
   (q_out 0.10..0.25, ``--device-sweep --q-in-grid 0.90 0.95 0.99
   --noise-margin-db 14 --analyze``: every point's artifacts, the sweep held
   to the same sweep on the CPU from the card's latents and fit, and at q_in
   0.95 to each point's ``summary.txt``), ``calibrate-tau --set-best`` (held to
   ``map_tau_sweep`` on the CPU from the card's latents), and the fleet scan
   ``scan-soundscape --root`` over 4 recordings x 10 min with planted calls at
   hop 2.5 s (960 windows, B = 1024; RMS fused into the mel kernel with
   ``--extract-dir``, then ``--no-normalize`` on pre-normalized audio): planted
   windows detected as their species, the first batch equal to
   ``encode_array`` on the card, 32 windows' parity-tier latents equal to the
   CPU's; times of the benchmark's encode, the device sweep, each grid point
   and the scan (windows/s, x realtime, extract and device ms a batch);
7. the kernel study, after every serving phase so that those run as they did
   before it existed: hold the split-bf16 tensor-core kernel
   (``fused_dots=True``) to its plain version, exact and bf16, at
   ``DEFAULT_MEL`` pre-padded, at the fast tier's frame range, at hop 320 and
   at R = 2, to the plain version with f64 sums, and the exact mode to the
   plain f32 version; hold each ablated instantiation of the Cooley-Tukey
   kernel to its ablated plain version (six classes and their floor in the
   exact mode, four and theirs in the bf16 mode); drive the study path at full width
   (B = 1024, 626 frames), counts set to 0 just before: the variants sweep
   (hop 384 and hop 320), the pre-padded variants, the ablation probe (exact
   and bf16), the stage split and the three-leg bench, through the ``main`` of
   each module of ``anuraxla_torch.probes`` and of ``anuraxla_torch.bench``
   (the split kernel's counts must move there); time the split kernel;
8. print the kernels line (``mel_power_ct``'s also with its launches on the
   fit path; every kernel's on the evaluation path), the card's name and power limit, and last the device line.

``--dense-checkpoints`` is a diagnostic: it also times the dense kernel between
the phases and, last, with its fragment tables uploaded again at other
addresses, and prints each time beside the addresses (``[dense-checkpoint]``
lines); and then the exact dense kernel at hops whose row stride in its staged
window gives 2-, 4- and 8-way ``ldmatrix`` bank conflicts (``[dense-strides]``
lines).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import re
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense rates): bf16 on the tensor
# cores and HBM3 bandwidth. Every kernel multiplies bf16 operands on the tensor
# cores with f32 sums, so each is bounded at the bf16 rate, its exact mode with
# the function's least work counted once for each of the three passes (hi*hi,
# hi*lo, lo*hi). The scale, window and power steps stay f32 but are under a
# tenth of the work; taking the whole at the bf16 rate can only lower the bound.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# kernel vs plain, each row against its own max |plain|. Exact modes: both
# sides are f32 sums in another order, REL_TOL on the largest difference.
# bf16 modes: both sides round the same values to bf16 at the same points, but
# an f32 value that differs in its last bit can round to the other bf16
# neighbour, 2^-8 .. 2^-7 relative away, and a row's largest mel values sit in
# narrow low bands that one or two bins dominate. The run shows this cause
# itself: it also holds kernel and plain version to the plain version with f64
# sums (rounding points unchanged), from which both differ alike. The largest
# difference is gated just above the largest measured (2.565e-3), and the
# MEAN difference at REL_TOL: flips are rare, a misplaced rounding point
# would move every value. With ablate=("power",) the bf16 mode rounds a SIGNED
# p = x_re + x_im, the filterbank sum cancels, and one term can exceed the row's
# max: there a single flip is held to one bf16 step (2^-7) of a term twice that
# max (the largest measured is 6.3e-3), and the mean gate carries the check.
# ablate=("splits",) (lo = -hi) makes every product a difference of two terms
# ~2^8 larger than itself, in both stages, so the accumulators' rounding shows
# ~2^16 larger: held to the same step; ablate=("dots",) is one bf16 pass, held
# to the bf16 gate.
REL_TOL = 2e-5
REL_TOL_BF16_MAX = 3e-3
REL_TOL_BF16_SIGNED_MAX = 2.0 ** -6
TIMING_B = 1024  # rows of a timed batch

PF = "anuraxla/ops/pallas_frontend.py"
KERNELS = {
    "mel_power_ct": ("anuraxla_torch/csrc/mel_power_ct.cu", f"{PF}:567 (_mel_power_ctp_kernel, exact)"),
    "mel_power_ct_bf16": ("anuraxla_torch/csrc/mel_power_ct.cu",
                          f"{PF}:567 (_mel_power_ctp_kernel, exact=False; _ct_outer_stage :493)"),
    "mel_power_ct_hop32": ("anuraxla_torch/csrc/mel_power_ct.cu", f"{PF}:739 (_mel_power_ct_kernel)"),
    "mel_power_dense": ("anuraxla_torch/csrc/mel_power_dense.cu", f"{PF}:66 (_mel_power_kernel, exact)"),
    "mel_power_dense_bf16": ("anuraxla_torch/csrc/mel_power_dense.cu", f"{PF}:66 (_mel_power_kernel, exact=False)"),
    "mel_power_ct_fused": ("anuraxla_torch/csrc/mel_power_ct_split.cu",
                           f"{PF}:513 (_ct_outer_stage_fused, exact; _ct_tables_folded_cat :197)"),
    "mel_power_ct_fused_bf16": ("anuraxla_torch/csrc/mel_power_ct_split.cu",
                                f"{PF}:513 (_ct_outer_stage_fused, exact=False :542-562)"),
}
FUSED = ("mel_power_ct_fused", "mel_power_ct_fused_bf16")  # launched by the study path alone


def log(msg: str) -> None:
    print(msg, flush=True)


def test_rows(cfg, B: int, rng: np.random.Generator) -> np.ndarray:
    """[B, num_samples] test signals: row 0 silent (below the RMS gate, raw
    passthrough), row 1 clips after RMS scaling."""
    y = (0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)
    y[0] = 1e-7 * rng.standard_normal(cfg.num_samples)
    y[1] = 0.001 * rng.standard_normal(cfg.num_samples)
    y[1, :: cfg.num_samples // 50] = 0.9  # sparse spikes >> RMS: clip after scaling
    return y


def pre_pad(cfg, y: np.ndarray) -> np.ndarray:
    """Rows in the ct kernel's pre-padded layout for the full clip."""
    from anuraxla_torch.probes.common import pre_padded_rows

    return pre_padded_rows(cfg, y)[0]


def frame_range(cfg, fast: bool):
    """(first_frame, num_frames): the full clip, or the fast frontend's crop."""
    total = cfg.total_frames
    if not fast:
        return 0, total
    return max(0, (total - cfg.target_frames) // 2), min(cfg.target_frames, total)


def mel_work(cfg, fb: np.ndarray, B: int, T: int, L: int):
    """(flops, bytes) the mel function needs for T frames of B rows, L samples
    of each row read, counted from its least work, not from how a kernel
    computes it: the RMS scale (one multiply a valid sample), the window, a
    real FFT of n_fft points (2.5 n log2 n flops), the power of each bin and
    the filterbank's nonzero products, 2 flops each. Bytes: rows, scales and
    tables read once, mel written once."""
    n_freq = cfg.n_fft // 2 + 1
    flops_frame = (cfg.n_fft + 2.5 * cfg.n_fft * np.log2(cfg.n_fft) + 3 * n_freq
                   + 2 * np.count_nonzero(fb))
    R = cfg.n_fft // 128
    n_half = R // 2 + 1
    tables = (2 * n_half * 128 * 128 + n_half * 128 * cfg.n_mels + cfg.n_fft) * 4
    nbytes = B * L * 4 + B * 4 + tables + B * T * cfg.n_mels * 4
    return float(flops_frame * B * T + B * min(L, cfg.num_samples)), nbytes


def ct_split_flops(cfg, B: int, T: int, exact: bool) -> float:
    """Tensor-core flops the split kernel's form does: per r one product of
    depth K1 (real-only r) or 2 K1 into 256 columns and one of depth K1 into
    the mels, K1 = 384 (hi, hi, lo segments) or 128 in the bf16 mode; its own
    work, not its bound."""
    R = cfg.n_fft // 128
    K1 = 384 if exact else 128
    fma = 0
    for r in range(R // 2 + 1):
        real = r == 0 or 2 * r == R
        fma += (1 if real else 2) * K1 * 256 + K1 * cfg.n_mels
    return 2.0 * fma * B * T


def dense_mma_flops(cfg, B: int, T: int, exact: bool) -> float:
    """Tensor-core flops the dense kernel's form does: frames against both
    bases (K = n_fft rounded up to 64, frequencies to 16), then the power
    against the filterbank (mels rounded up to 8), three passes in the exact
    mode; its own work, not its bound."""
    from anuraxla_torch.ops.mel_kernel import DENSE_KC

    k_pad = -(-cfg.n_fft // DENSE_KC) * DENSE_KC
    n_freq_pad = -(-(cfg.n_fft // 2 + 1) // 16) * 16
    per_pass = 2 * k_pad * n_freq_pad + n_freq_pad * 8 * -(-cfg.n_mels // 8)
    return 2.0 * (3 if exact else 1) * per_pass * B * T


def phase_build() -> None:
    from anuraxla_torch.ops import _build
    from anuraxla_torch.ops.mel_kernel import ablate_library, ablate_mask

    # every source, and the ablated instantiations this run compares and times
    names = _build.sources() + sorted({ablate_library(ablate_mask(a)) for a in ABLATIONS})
    t0 = time.perf_counter()
    _build.build(names)
    # loaded now: the serving libraries alone. The study's load at their first
    # use, after every serving phase, so that those phases run in a process
    # that holds what it held before the study existed
    study = {Path(KERNELS[k][0]).stem for k in FUSED}
    serving = [name for name in _build.sources() if name not in study]
    for name in serving:
        _build.load(name)
    log(f"[build] {', '.join(names)} built (one nvcc each, together) in {time.perf_counter() - t0:.2f} s; "
        f"loaded: {', '.join(serving)}")
    for name in _build.sources():
        for line in _build.lib_path(name).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {name}: {line.strip()}")


def configs():
    """The mel configs this run uses, by label."""
    from anuraxla_torch.constants import DEFAULT_MEL, MelConfig

    small = dict(sr=16000, duration=0.5, n_mels=32, fmin=100, fmax=7500, target_frames=48)
    return {
        "DEFAULT_MEL": DEFAULT_MEL,
        "hop320": DEFAULT_MEL.replace(hop_length=320),
        "hop160": DEFAULT_MEL.replace(hop_length=160),
        "hop240": DEFAULT_MEL.replace(hop_length=240),
        "n_fft256_hop128": MelConfig(**small, hop_length=128, n_fft=256),
        "n_fft512_hop96": MelConfig(**small, hop_length=96, n_fft=512),
        "n_fft400_hop80": MelConfig(**small, hop_length=80, n_fft=400),
    }


def kernel_inputs(cfg, B: int, rng, *, fast: bool, pre_padded: bool):
    """(rows on the card as the kernel takes them, the same rows centre-padded
    for the plain version, scale, first_frame, num_frames)."""
    from anuraxla_torch.ops.frontend import rms_scale_batch

    y = test_rows(cfg, B, rng)
    raw = torch.from_numpy(y).cuda()
    s = rms_scale_batch(raw)
    if not (float(s[0]) == -1.0 and float(s[1]) > 0):
        raise AssertionError(f"test rows: expected a silent and a scaled row, got scales {s[:2]}")
    first, T = frame_range(cfg, fast)
    if pre_padded:
        x = torch.from_numpy(pre_pad(cfg, y)).cuda()
        return x, x, s, first, T
    pad = cfg.n_fft // 2
    return raw, torch.nn.functional.pad(raw, (pad, pad)), s, first, T


class Case(NamedTuple):
    """One kernel-vs-plain comparison."""
    kernel: str  # the launch counter that must move
    label: str  # config, by its name in configs()
    B: int
    exact: bool
    algorithm: str = "ct"
    fast: bool = False  # the fast frontend's frame range
    pre_padded: bool = False
    fused: bool = False  # the split kernel (fused_dots=True)
    ablate: tuple = ()  # classes dropped (profiling instantiations)


# the first case of each kernel is at the shape its main path gives it
CASES = [
    Case("mel_power_ct", "DEFAULT_MEL", 64, True, pre_padded=True),
    Case("mel_power_ct", "n_fft256_hop128", 8, True, pre_padded=True),
    Case("mel_power_ct_bf16", "DEFAULT_MEL", 64, False, fast=True),
    Case("mel_power_ct_bf16", "DEFAULT_MEL", 64, False, pre_padded=True),
    Case("mel_power_ct_hop32", "hop320", 32, True),
    Case("mel_power_ct_hop32", "hop160", 16, True),
    Case("mel_power_ct_hop32", "n_fft512_hop96", 8, True),
    Case("mel_power_dense", "hop240", 8, True, "dense"),
    Case("mel_power_dense", "n_fft400_hop80", 8, True, "dense"),
    Case("mel_power_dense_bf16", "hop240", 8, False, "dense", fast=True),
    Case("mel_power_dense_bf16", "hop240", 8, False, "dense"),
    Case("mel_power_dense_bf16", "n_fft400_hop80", 8, False, "dense"),
]
# the kernel study's cases. They run after the serving phases and draw their
# rows from a generator of their own, so that neither the inputs of the
# serving phases nor the state of the card at their timings depends on them
STUDY_CASES = [
    Case("mel_power_ct_fused", "DEFAULT_MEL", 64, True, pre_padded=True, fused=True),
    Case("mel_power_ct_fused", "DEFAULT_MEL", 64, True, fast=True, fused=True),
    Case("mel_power_ct_fused", "hop320", 32, True, fused=True),
    Case("mel_power_ct_fused", "n_fft256_hop128", 8, True, pre_padded=True, fused=True),
    Case("mel_power_ct_fused_bf16", "DEFAULT_MEL", 64, False, pre_padded=True, fused=True),
    Case("mel_power_ct_fused_bf16", "DEFAULT_MEL", 64, False, fast=True, fused=True),
    Case("mel_power_ct_fused_bf16", "hop320", 32, False, fused=True),
]
# each wired ablation class and the probe's floor (every class of the mode):
# six in the exact mode, the four that are not the split's in the bf16 mode;
# their launches count under the intact kernel's name
ABLATE_BF16 = ("window", "inner", "power", "fb")
ABLATE_EXACT = ABLATE_BF16 + ("splits", "dots")
ABLATIONS = [(c,) for c in ABLATE_EXACT] + [ABLATE_EXACT, ABLATE_BF16]
STUDY_CASES += [Case("mel_power_ct" if exact else "mel_power_ct_bf16", "DEFAULT_MEL", 16, exact, pre_padded=True,
                     ablate=a) for exact in (True, False) for a in ABLATIONS
                if exact or set(a) <= set(ABLATE_BF16)]


def row_rel(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|got - ref| of each row's max |ref|, elementwise."""
    return (got - ref).abs() / ref.abs().amax(dim=(1, 2), keepdim=True)


def phase_kernel_vs_plain(cases, rng) -> dict:
    """-> {kernel: (max_abs_err, max_rel_err)} at each kernel's main-path shape."""
    from anuraxla_torch.ops import mel_kernel as mk

    if set(KERNELS) != set(mk.KERNEL_NAMES):
        raise AssertionError(f"this script lists {sorted(KERNELS)}, the wrapper counts {mk.KERNEL_NAMES}")
    if ABLATE_EXACT != mk.ABLATE_CLASSES or set(ABLATE_EXACT) - set(ABLATE_BF16) != set(mk.EXACT_ONLY_CLASSES):
        raise AssertionError(f"this script ablates {ABLATIONS}, the wrapper wires {mk.ABLATE_CLASSES}")
    result, failures = {}, []
    for case in cases:
        kernel, label, B, exact = case.kernel, case.label, case.B, case.exact
        cfg = configs()[label]
        x, x_padded, s, first, T = kernel_inputs(cfg, B, rng, fast=case.fast, pre_padded=case.pre_padded)
        n0 = mk.mel_power.launches[kernel]
        got = mk.mel_power(x, cfg, num_frames=T, first_frame=first, rms_scale=s, pre_padded=case.pre_padded,
                           exact=exact, algorithm=case.algorithm, fused_dots=case.fused, ablate=case.ablate)
        if mk.mel_power.launches[kernel] != n0 + 1:
            raise AssertionError(f"{kernel} {label}: the wrapper did not count its launch")
        if case.fused:
            plain = mk.mel_power_ct_fused_plain
        elif case.algorithm == "dense":
            plain = mk.mel_power_dense_split_plain
        else:  # the split arithmetic; in the bf16 mode the plain bf16 version itself
            plain = functools.partial(mk.mel_power_ct_split_plain, ablate=case.ablate)
        ref = plain(x_padded, s, cfg, T, first_frame=first, exact=exact)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{kernel} {label}: kernel output not finite or of the wrong shape")
        abs_err = float((got - ref).abs().max())
        # each row against its own max, so the silent row (mel power ~1e-12
        # of the others, raw passthrough) is held to the same bound
        rel = row_rel(got, ref)
        per_row = rel.amax(dim=(1, 2))
        worst, mean = float(per_row.max()), float(rel.mean())
        signed_p = "power" in case.ablate and "fb" not in case.ablate  # fb dropped: p is not rounded
        if exact and not set(case.ablate) & {"splits", "dots"}:
            tol = REL_TOL
        elif signed_p or "splits" in case.ablate:
            tol = REL_TOL_BF16_SIGNED_MAX
        else:
            tol = REL_TOL_BF16_MAX
        what = f"{kernel}{' ablate=' + '+'.join(case.ablate) if case.ablate else ''} {label}"
        log(f"[kernel-vs-plain] {what} B={B} frames {first}..{first + T - 1}: "
            f"max|diff|={abs_err:.3e}; of each row's max: worst {worst:.3e} (tol {tol}), "
            f"mean {mean:.3e} (tol {REL_TOL}), share above {REL_TOL}: {float((rel > REL_TOL).float().mean()):.4f} "
            f"(silent row {float(per_row[0]):.3e}, clipping row {float(per_row[1]):.3e})")
        if not case.ablate:
            # where the differences come from: the same rounding points with
            # f64 sums, the tensor cores' f32 accumulation against an exact sum
            # of the same bf16 products
            ref64 = plain(x_padded, s, cfg, T, first_frame=first, exact=exact, sums=torch.float64)
            vs64 = {n: row_rel(v, ref64) for n, v in (("kernel", got), ("plain", ref))}
            log(f"[kernel-vs-plain]   against the plain version with f64 sums, of each row's max: " + "; ".join(
                f"{n} worst {float(r.max()):.3e}, mean {float(r.mean()):.3e}, share above {REL_TOL}: "
                f"{float((r > REL_TOL).float().mean()):.4f}" for n, r in vs64.items()))
            del ref64, vs64
        if not (worst <= tol and mean <= REL_TOL):
            failures.append(f"{what}: kernel disagrees with plain version (worst {worst:.3e}, mean {mean:.3e})")
        if exact and not case.ablate:
            # the split scheme must hold the exact tier's gate against plain
            # f32 arithmetic too (this also catches a fault in the shared tables)
            f32 = (mk.mel_power_dense_plain if case.algorithm == "dense" else mk.mel_power_ct_plain)(
                x_padded, s, cfg, T, first_frame=first)
            vs_f32 = row_rel(got, f32)
            log(f"[kernel-vs-plain]   against the plain f32 version (no split), of each row's max: "
                f"worst {float(vs_f32.max()):.3e} (tol {REL_TOL}), mean {float(vs_f32.mean()):.3e}")
            if not float(vs_f32.max()) <= REL_TOL:
                failures.append(f"{what}: the split scheme misses the exact gate (worst {float(vs_f32.max()):.3e})")
        if not case.ablate:
            result.setdefault(kernel, (abs_err, worst))
    if failures:
        raise AssertionError("; ".join(failures))
    return result


def write_inputs(d: Path, cfg, rng) -> list:
    from anuraxla_torch.utils.wavio import write_wav

    t = np.arange(cfg.num_samples) / cfg.sr
    paths = []
    for i in range(6):
        tone = np.sin(2 * np.pi * (600 + 700 * i) * t) * (rng.random(t.size) > 0.4)
        y = 0.3 * tone + 0.02 * rng.standard_normal(t.size)
        if i == 5:
            y = 5e-5 * rng.standard_normal(t.size)  # below the RMS gate, above PCM16's LSB
        p = d / f"chunk_{i}.wav"
        write_wav(p, y.astype(np.float32), cfg.sr)
        paths.append(p)
    return paths


def write_config(path: Path, Z: np.ndarray) -> Path:
    """A radial block: species 0 centred on chunk 0 with a radius between
    the 3rd and 4th nearest chunks (three accepts, three rejects), species 1
    centred on chunk 1 with a radius that holds chunk 1 alone."""
    sp = ["Batrachyla_leptopus", "Pleurodema_thaul"]
    d0 = np.sort(np.linalg.norm(Z - Z[0], axis=1))
    d1 = np.linalg.norm(Z - Z[1], axis=1)
    cfg = {
        "species": sp,
        "chunk_seconds": 5.0,
        "radial_detector": {
            "centroids": {sp[0]: Z[0].tolist(), sp[1]: Z[1].tolist()},
            "thresholds": {sp[0]: float(d0[2] + d0[3]) / 2, sp[1]: 0.5 * float(d1[d1 > 0].min())},
        },
    }
    path.write_text(json.dumps(cfg))
    return path


def live_cosine(Za: np.ndarray, Zb: np.ndarray, what: str) -> np.ndarray:
    """Row cosines over the chunks whose latents are nonzero. A chunk that
    standardizes to an all-zero mel gives mu = 0 whatever the tier (zero
    biases); both sides must agree on which chunks those are."""
    na, nb = np.linalg.norm(Za, axis=1), np.linalg.norm(Zb, axis=1)
    live = na > 0
    if not np.array_equal(live, nb > 0) or not live.any():
        raise AssertionError(f"{what}: zero latents differ: {na} vs {nb}")
    return (Za * Zb).sum(axis=1)[live] / (na * nb)[live]


def drive_path(label, kernel, paths, cfg_path, params, mel, knobs, *, f32_gate):
    """One main path on the card: ``encode_paths`` + ``detect_species`` on the
    WAVs with the session the tier's knobs give, and with an f32 trunk where
    the tier's is bf16; launch counts set to 0 just before, read just after.
    The f32-trunk latents are held to the same session on the CPU
    (``f32_gate`` "allclose": rtol 5e-4 / atol 2e-5; "cosine": >= 0.999 on
    live chunks — the bf16 mel modes, where a last-bit difference can flip a
    bf16 rounding) and the decisions must be identical. -> launches of
    ``kernel`` on the path."""
    from anuraxla_torch.cli.evaluate_wav import detect_species
    from anuraxla_torch.ops.mel_kernel import mel_power, reset_launches
    from anuraxla_torch.pipeline.session import EncoderSession

    kw = dict(mel=mel, normalize_on_device=True, **{k: v for k, v in knobs.items() if k != "encoder_dtype"})
    tiers = {knobs["encoder_dtype"]: None, "float32": None}  # the tier's trunk first
    cpu = EncoderSession(**kw, device="cpu").load(params)
    Zc, okc, _ = cpu.encode_paths(paths)
    write_config(cfg_path, Zc)
    decc = [detect_species(p, cpu, cfg_path)[:2] for p in paths]
    sessions = {dt: EncoderSession(**kw, encoder_dtype=dt, device="cuda").load(params) for dt in tiers}

    reset_launches()  # count only the main path from here
    out = {}
    for dt, sess in sessions.items():
        Z, ok, err = sess.encode_paths(paths)
        out[dt] = (Z, ok, err, [detect_species(p, sess, cfg_path)[:2] for p in paths])
    torch.cuda.synchronize()
    counts = dict(mel_power.launches)
    log(f"[main-path {label}] encode_paths + detect_species, {len(paths)} WAVs x {len(sessions)} "
        f"trunk dtype(s) {list(sessions)}: launches {counts}")
    if counts[kernel] <= 0:
        raise AssertionError(f"{label}: the main path did not launch {kernel}")
    if any(counts[k] for k in FUSED):
        raise AssertionError(f"{label}: a serving path launched the study's split kernel: {counts}")

    for dt, (Z, ok, err, _) in out.items():
        if not (ok.all() and okc.all()):
            raise AssertionError(f"{label}: decode failures: {err}")
        if Z.shape != (len(paths), 128) or not np.isfinite(Z).all():
            raise AssertionError(f"{label} {dt}: latents not finite or of the wrong shape")
    Z32, _, _, dec32 = out["float32"]
    if f32_gate == "allclose":
        np.testing.assert_allclose(Z32, Zc, rtol=5e-4, atol=2e-5)
        log(f"[main-path {label}] f32 latents vs CPU: max|diff|={np.abs(Z32 - Zc).max():.3e} (rtol 5e-4, atol 2e-5)")
    else:
        cos = live_cosine(Z32, Zc, f"{label} f32 trunk vs CPU")
        log(f"[main-path {label}] f32-trunk latents vs CPU: cosine min={cos.min():.6f} (>= 0.999), "
            f"max|diff|={np.abs(Z32 - Zc).max():.3e}")
        if not cos.min() >= 0.999:
            raise AssertionError(f"{label}: latents on the card drifted from the CPU's")
    if dec32 != decc:
        raise AssertionError(f"{label}: decisions differ: cuda {dec32} vs cpu {decc}")
    log(f"[main-path {label}] decisions (f32 trunk, identical to CPU): {dec32}")
    if not dec32[0][0]:
        raise AssertionError(f"{label}: chunk 0 sits on a centroid and must be detected")
    if "bfloat16" in out:
        Z16, _, _, dec16 = out["bfloat16"]
        cos = live_cosine(Z16, Z32, f"{label} bf16 vs f32 trunk")
        log(f"[main-path {label}] bf16 vs f32 trunk latent cosine min={cos.min():.6f} (> 0.99); "
            f"bf16 decisions {dec16}")
        if not cos.min() > 0.99:
            raise AssertionError(f"{label}: bf16 trunk drifted from f32")
    return counts[kernel]


def phase_main_paths(seed: int, rng) -> dict:
    """-> {kernel: launches on its main path}."""
    import argparse as ap

    from anuraxla_torch.cli.common import SERVING_TIERS, session_kwargs
    from anuraxla_torch.models.vae import VAEConfig, init_encoder_params

    def knobs(tier: str, **extra) -> dict:
        kw = session_kwargs(ap.Namespace(serving_tier=tier, batch_size=4, io_threads=8, **extra))
        assert kw["backend"] == SERVING_TIERS[tier]["frontend_backend"]
        return kw

    cfgs = configs()
    params = init_encoder_params(VAEConfig(), torch.Generator().manual_seed(seed))
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        paths = write_inputs(d, cfgs["DEFAULT_MEL"], rng)  # 5 s at 48 kHz: every config here reads them
        # the first slice's path: balanced (bf16 trunk) and parity (f32 trunk), pre-padded host rows
        launches["mel_power_ct"] = drive_path(
            "balanced+parity DEFAULT_MEL", "mel_power_ct", paths, d / "c0.json", params,
            cfgs["DEFAULT_MEL"], knobs("balanced", pre_padded_host=True), f32_gate="allclose")
        launches["mel_power_ct_bf16"] = drive_path(
            "fast DEFAULT_MEL", "mel_power_ct_bf16", paths, d / "c1.json", params,
            cfgs["DEFAULT_MEL"], knobs("fast"), f32_gate="cosine")
        launches["mel_power_ct_hop32"] = drive_path(
            "parity hop320", "mel_power_ct_hop32", paths, d / "c2.json", params,
            cfgs["hop320"], knobs("parity"), f32_gate="allclose")
        launches["mel_power_dense"] = drive_path(
            "parity hop240", "mel_power_dense", paths, d / "c3.json", params,
            cfgs["hop240"], knobs("parity"), f32_gate="allclose")
        launches["mel_power_dense_bf16"] = drive_path(
            "fast hop240", "mel_power_dense_bf16", paths, d / "c4.json", params,
            cfgs["hop240"], knobs("fast"), f32_gate="cosine")
    return launches


def phase_study_path() -> dict:
    """The kernel-study path at full width (``DEFAULT_MEL``, B = 1024, 626
    frames, default ``VAEConfig``), through the entry points a user calls: the
    ``main`` of each probe and of the bench, with a short measuring time. Launch counts are set
    to 0 just before and read just after. Each probe's JSON lines are checked:
    times positive and finite, the split kernel within its gates of the
    non-fused exact kernel (2e-5 exact; 5e-3 for a bf16 mode against the exact
    kernel, the reference suite's gate). -> {kernel: launches}."""
    from anuraxla_torch.ops.mel_kernel import mel_power, reset_launches
    from anuraxla_torch import bench
    from anuraxla_torch.probes import kernel_ablation, kernel_variants, phase_variants, profile_stages

    size = ["--batch", str(TIMING_B), "--measure-s", "0.5"]

    def run(name, main, argv, frames=626):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            main(size + argv)
        records = [json.loads(line) for line in out.getvalue().splitlines()]
        for rec in records:
            log(f"[study-path {name}] {json.dumps(rec)}")
            ms = rec.get("ms_per_batch")
            if ms is not None and not (np.isfinite(ms) and ms > 0):
                raise AssertionError(f"{name}: no time in {rec}")
        head = records[0]
        if head["batch"] != TIMING_B or head["frames"] != frames or "H100" not in head["device"]:
            raise AssertionError(f"{name}: not the full-width run on the card: {head}")
        return records[1:]

    reset_launches()  # count only the study path from here
    for name, hop, frames in (("kernel_variants", [], 626), ("kernel_variants hop320", ["--hop-length", "320"], 751)):
        variants = run(name, kernel_variants.main, ["--bf16"] + hop, frames)
        if [(r["fused"], r["exact"]) for r in variants] != [(False, True), (False, False), (True, True), (True, False)]:
            raise AssertionError(f"{name}: unexpected sweep {variants}")
        for r in variants:
            gate = REL_TOL if r["exact"] else 5e-3
            if not r["max_rel_err_vs_baseline"] <= gate:
                raise AssertionError(f"{name}: {r} is past {gate} of the non-fused exact kernel")
        if hop and mel_power.launches["mel_power_ct_hop32"] <= 0:
            raise AssertionError(f"{name}: the hop % 32 family's kernel was not launched")
    phases = run("phase_variants", phase_variants.main, [])
    if len(phases) != 2 or not all(r["max_rel_err_vs_first"] <= REL_TOL for r in phases):
        raise AssertionError(f"phase_variants: the fused variant is past {REL_TOL} of the first: {phases}")
    for mode in ([], ["--bf16"]):
        rows = run("kernel_ablation" + "".join(mode), kernel_ablation.main, mode)
        timed = {r["variant"]: r["ms_per_batch"] for r in rows if "ms_per_batch" in r}
        if not timed["floor"] < min(timed["baseline"], timed["baseline-close"]):
            raise AssertionError(f"kernel_ablation: dropping every class did not shorten the kernel: {timed}")
    stages = run("profile_stages", profile_stages.main, [])
    if [r["stage"] for r in stages] != ["full", "melpow", "frontend", "encoder", "detect"]:
        raise AssertionError(f"profile_stages: unexpected stages {stages}")
    # the bench prints one line: three legs (balanced, f32 encoder, fast tier), each a positive rate
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main(["--batch", str(TIMING_B), "--measure-s", "0.5", "--max-leg-s", "5"])
    (rec,) = [json.loads(line) for line in out.getvalue().splitlines()]
    log(f"[study-path bench] {json.dumps(rec)}")
    rates = [rec["value"], rec["value_f32_encoder"], rec["value_fast_tier"]]
    if rec["batch"] != TIMING_B or "H100" not in rec["device"] or not all(np.isfinite(r) and r > 0 for r in rates):
        raise AssertionError(f"bench: not three positive rates at full width on the card: {rec}")
    if not all(w and all(x > 0 for x in w) for w in rec["windows"].values()):
        raise AssertionError(f"bench: a leg measured no window: {rec['windows']}")
    torch.cuda.synchronize()
    counts = dict(mel_power.launches)
    log(f"[study-path] B={TIMING_B} x 626 frames (751 at hop 320), four probes and the bench: launches {counts}")
    for k in FUSED:
        if counts[k] <= 0:
            raise AssertionError(f"the study path did not launch {k}")
    torch.cuda.empty_cache()
    return {k: counts[k] for k in FUSED}


def library_mel(cfg, raw: torch.Tensor, first: int, T: int, fb: torch.Tensor, win: torch.Tensor):
    """The library yardstick (never called by the port): one ``torch.stft``
    over the samples the frames need -> |.|^2 @ FB."""
    kw = dict(window=win, onesided=True, return_complex=True)
    if (first, T) == (0, cfg.total_frames):
        X = torch.stft(raw, cfg.n_fft, cfg.hop_length, center=True, pad_mode="constant", **kw)
    else:
        start = first * cfg.hop_length - cfg.n_fft // 2
        stop = start + (T - 1) * cfg.hop_length + cfg.n_fft
        if start < 0 or stop > raw.shape[1]:
            raise ValueError("library_mel: the frame range must lie inside the clip")
        X = torch.stft(raw[:, start:stop], cfg.n_fft, cfg.hop_length, center=False, **kw)
    return (X.real.square() + X.imag.square()).transpose(1, 2) @ fb


def time_kernel(kernel: str, label: str, B: int, rng, *, exact: bool, algorithm: str,
                fast: bool, pre_padded: bool, iters: int, fused: bool = False, plain: bool = True) -> dict:
    """Kernel, plain version (``plain=False``: not timed, where its operands
    would not fit the card), library call (CUDA events) and the bound, at one
    config and batch."""
    from anuraxla_torch.bench import ct_mma_flops
    from anuraxla_torch.ops import mel_kernel as mk
    from anuraxla_torch.ops.mel import mel_filterbank
    from anuraxla_torch.probes.common import cuda_ms

    cfg = configs()[label]
    x, x_padded, s, first, T = kernel_inputs(cfg, B, rng, fast=fast, pre_padded=pre_padded)
    ms = cuda_ms(lambda: mk.mel_power(x, cfg, num_frames=T, first_frame=first, rms_scale=s, pre_padded=pre_padded,
                                      exact=exact, algorithm=algorithm, fused_dots=fused), iters=iters)
    plain_fn = (mk.mel_power_ct_fused_plain if fused else mk.mel_power_ct_split_plain if algorithm == "ct"
                else mk.mel_power_dense_split_plain)
    plain_ms = (cuda_ms(lambda: plain_fn(x_padded, s, cfg, T, first_frame=first, exact=exact), iters=2, warmup=1)
                if plain else None)
    fb_np = mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    # samples of a row the frames need: the whole row as given for the full
    # clip, else the frame range's span
    L = x.shape[1] if not fast else (T - 1) * cfg.hop_length + cfg.n_fft
    flops, nbytes = mel_work(cfg, fb_np, B, T, L)
    # every kernel multiplies bf16 operands on the tensor cores; an exact mode
    # makes three passes
    passes = 3 if exact else 1
    flops *= passes
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    if fused:
        own, tile = ct_split_flops(cfg, B, T, exact), "32 frames a block"
    elif algorithm == "dense":
        own = dense_mma_flops(cfg, B, T, exact)
        tile = "(frames a block, k16 steps a ring buffer, buffers) = {}".format(
            mk.dense_tile(cfg.n_fft, cfg.hop_length, exact))
    else:
        own = ct_mma_flops(cfg, B, T, exact)
        tile = f"{mk.ct_tile(cfg.n_fft, cfg.hop_length, exact)} frames a block"

    off = cfg.n_fft // 2
    raw = x[:, off : off + cfg.num_samples] if pre_padded else x
    win = torch.hann_window(cfg.n_fft, periodic=True, device="cuda")
    fb = torch.from_numpy(fb_np).cuda()
    library_ms = cuda_ms(lambda: library_mel(cfg, raw, first, T, fb, win), iters=5)
    tables = mk._tables(cfg, x.device, "ct_frag" if fused else "dense_frag" if algorithm == "dense" else "ct_split_frag",
                        exact)
    plain_txt = f"{plain_ms:.3f} ms" if plain else "not timed"
    log(f"[times] {kernel} {label} B={B} frames {first}..{first + T - 1}: kernel {ms:.3f} ms, "
        f"plain {plain_txt}, library(torch.stft) {library_ms:.3f} ms (kernel/library {ms / library_ms:.2f}x), "
        f"bound {bound_ms:.3f} ms by {bound_by} (function's least work: {flops / 1e9:.2f} GFLOP "
        f"{'x 3 passes ' if passes == 3 else ''}-> {t_ops:.3f} ms at the bf16 peak, {nbytes / 1e9:.3f} GB -> "
        f"{t_bytes:.3f} ms) = {100 * bound_ms / ms:.2f}% of bound; the kernel's own form does {own / 1e12:.3f} "
        f"TFLOP = {own / ms / 1e9:.2f} TFLOP/s on bf16 mma.sync; tile {tile}; "
        f"tables at {[hex(t.data_ptr()) for t in tables]}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                config=f"{label} B={B} frames {first}..{first + T - 1}", tile=tile)


def dense_checkpoint(where: str, shift_mb: int | None = None) -> None:
    """Diagnostic (``--dense-checkpoints``): the dense kernel's time at this
    point of the run, at the shape it is timed at, on rows of its own, with
    the device addresses of its tables and rows. Every block streams the
    kernel's 17.0 MB of exact-mode basis fragments from L2 (the FP32 kernel it
    replaced read its two 9.4 MB bases, and its time followed where the
    allocator put them), so its time can depend on where they lie, which
    depends on everything the process did before. ``shift_mb``: first drop the
    tables from the device and hold that many MB, so that they are uploaded
    again somewhere else."""
    from anuraxla_torch.ops import mel_kernel as mk
    from anuraxla_torch.probes.common import cuda_ms

    cfg = configs()["hop240"]
    hold = None
    if shift_mb is not None:
        mk._device_tables.cache_clear()
        torch.cuda.empty_cache()
        hold = torch.empty(shift_mb << 20, dtype=torch.uint8, device="cuda")
    x = torch.from_numpy(test_rows(cfg, TIMING_B // 4, np.random.default_rng(240))).cuda()
    ms = cuda_ms(lambda: mk.mel_power(x, cfg, num_frames=cfg.total_frames, algorithm="dense"), iters=3)
    tabs = mk._tables(cfg, x.device, "dense_frag", True)
    log(f"[dense-checkpoint] {where}: mel_power_dense hop240 B={TIMING_B // 4} {ms:.3f} ms; bases, FB at "
        f"{[hex(t.data_ptr()) for t in tabs]}, rows at {hex(x.data_ptr())}; "
        f"{torch.cuda.memory_allocated() >> 20} MB allocated, {torch.cuda.memory_reserved() >> 20} MB reserved")
    del x, hold


def dense_strides() -> None:
    """Diagnostic (``--dense-checkpoints``): the exact dense kernel at n_fft 2048
    on the same number of frames (B = 256 x 626), at hops whose row stride
    in the staged bf16 window (2 * hop bytes) puts the eight row addresses of
    one ``ldmatrix`` phase on 2, 4 or 8 ways of a bank: only the window's
    length and its bank conflicts differ."""
    from anuraxla_torch.constants import DEFAULT_MEL
    from anuraxla_torch.ops import mel_kernel as mk
    from anuraxla_torch.probes.common import cuda_ms

    T, B = 626, TIMING_B // 4
    for hop in (240, 208, 224, 192):  # each at 128 frames a block
        cfg = DEFAULT_MEL.replace(hop_length=hop)
        ways = 8 // len({(r * 2 * hop // 16) % 8 for r in range(8)})
        x = torch.from_numpy(test_rows(cfg, B, np.random.default_rng(hop))).cuda()
        ms = cuda_ms(lambda: mk.mel_power(x, cfg, num_frames=T, algorithm="dense"), iters=3)
        log(f"[dense-strides] hop {hop} (row stride {2 * hop} B, {ways}-way ldmatrix phases), "
            f"tile {mk.dense_tile(cfg.n_fft, hop, True)}: mel_power_dense B={B} x {T} frames {ms:.3f} ms")
        del x


def phase_times(seed: int, rng, profile: bool = False, checkpoint=lambda where: None) -> dict:
    """-> {"chunks_per_s": {...}, kernel: times}. ``checkpoint(where)`` is
    called between its steps (``--dense-checkpoints``)."""
    from anuraxla_torch.cli.common import SERVING_TIERS
    from anuraxla_torch.constants import DEFAULT_MEL as cfg
    from anuraxla_torch.models.vae import VAEConfig, init_encoder_params
    from anuraxla_torch.ops.frontend import log_mel_batch, mel_to_encoder_input, rms_scale_batch
    from anuraxla_torch.pipeline.session import EncoderSession
    from anuraxla_torch.probes.common import cuda_ms

    params = init_encoder_params(VAEConfig(), torch.Generator().manual_seed(seed))
    B = TIMING_B
    y = test_rows(cfg, B, rng)
    out = {"chunks_per_s": {}}

    def tier_session(tier: str, **extra) -> EncoderSession:
        k = SERVING_TIERS[tier]
        return EncoderSession(mel=cfg, batch_size=B, normalize_on_device=True, parity=not k["fast_frontend"],
                              backend=k["frontend_backend"], encoder_dtype=k["encoder_dtype"], **extra).load(params)

    sessions = {"balanced": (tier_session("balanced", pre_padded_host=True), pre_pad(cfg, y)),
                "fast": (tier_session("fast"), y)}
    for tier, (sess, rows) in sessions.items():
        for _ in range(2):  # warm-up; allocates both pinned host buffers
            sess.encode_array(rows)
        torch.cuda.synchronize()
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            Z = sess.encode_array(rows)
        dt = (time.perf_counter() - t0) / reps
        assert Z.shape == (B, 128) and np.isfinite(Z).all()
        out["chunks_per_s"][tier] = B / dt
        log(f"[times] encode_array {tier} tier B={B} (rows {rows.shape[1]} samples, host->device included): "
            f"{dt * 1e3:.2f} ms/batch = {B / dt:.1f} chunks/s")

    # where a served batch's time goes, B = 1024: host rows -> device, then
    # the device forward split into frontend (RMS + mel kernel + epilogue)
    # and encoder
    for tier, (sess, rows) in sessions.items():
        t0 = time.perf_counter()
        dev = sess._to_device(rows)
        torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - t0) * 1e3
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: sess._forward(dev), iters=5)
            off = sess._layout[1] if sess._layout is not None else 0
            s = rms_scale_batch(dev[:, off : off + cfg.num_samples])
            front = lambda: log_mel_batch(dev, cfg, parity=sess.parity, backend=sess.backend,  # noqa: E731
                                          rms_scale=s, pre_padded=sess._layout is not None)
            front_ms = cuda_ms(front, iters=5)
            x = mel_to_encoder_input(front())
            enc_ms = cuda_ms(lambda: sess._enc(x), iters=5)
            if profile:
                from torch.profiler import ProfilerActivity, profile as tprofile

                with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    sess._forward(dev)
                    torch.cuda.synchronize()
                log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))
        log(f"[times] {tier} tier B={B} breakdown: host->device (pinned copy + transfer) {h2d_ms:.2f} ms, "
            f"device forward {fwd_ms:.3f} ms = {B / fwd_ms * 1e3:.1f} chunks/s "
            f"(frontend {front_ms:.3f} ms, encoder bf16 {enc_ms:.3f} ms)")
        del dev, x
    del sessions
    torch.cuda.empty_cache()
    checkpoint("after the tiers' timings")

    out["mel_power_ct"] = time_kernel("mel_power_ct", "DEFAULT_MEL", B, rng, exact=True, algorithm="ct",
                                      fast=False, pre_padded=True, iters=10)
    out["mel_power_ct_bf16"] = time_kernel("mel_power_ct_bf16", "DEFAULT_MEL", B, rng, exact=False,
                                           algorithm="ct", fast=True, pre_padded=False, iters=10)
    out["mel_power_ct_hop32"] = time_kernel("mel_power_ct_hop32", "hop320", B, rng, exact=True,
                                            algorithm="ct", fast=False, pre_padded=False, iters=5)
    checkpoint("after the ct kernels' timings")
    # the dense form does ~135x the function's least work: the kernels line keeps a
    # quarter of the batch, the shape of earlier runs; the whole batch is timed too
    out["mel_power_dense"] = time_kernel("mel_power_dense", "hop240", B // 4, rng, exact=True,
                                         algorithm="dense", fast=False, pre_padded=False, iters=3)
    time_kernel("mel_power_dense", "hop240", B, rng, exact=True, algorithm="dense", fast=False,
                pre_padded=False, iters=3, plain=False)
    out["mel_power_dense_bf16"] = time_kernel("mel_power_dense_bf16", "hop240", B, rng, exact=False,
                                              algorithm="dense", fast=True, pre_padded=False, iters=3)
    checkpoint("after the dense kernels' timings")
    return out


FIT_FILES = 48  # WAVs of each species in the fit phase's tree
FIT_TIMING_PATHS = 4096  # paths of each timed encode_paths run (the tree's files, listed again and again)
# the card's fit against the same fit on the CPU from the same latents: only
# the fit arithmetic differs (sum order; cuSOLVER against LAPACK). Vectors
# (centroids, MAP means) are held per species to rtol of their largest
# component, where a near-zero component carries no relative precision of its own
FIT_RTOL = 1e-5  # centroids, rk, MAP means
FIT_RTOL_LOGDET = 1e-4  # logdets and tau


BANDS = (700.0, 1900.0, 3700.0, 6500.0)  # each species' tone band, in PRIORITY_ORDER


def tone_chunk(t: np.ndarray, rng, f: float) -> np.ndarray:
    """A tone at ``f`` gated on and off, plus noise (noise alone for f = 0)."""
    tone = np.sin(2 * np.pi * f * t) * (rng.random(t.size) > 0.4) if f else 0.0
    return (0.3 * tone + 0.02 * rng.standard_normal(t.size)).astype(np.float32)


def write_species_files(d: Path, cfg, rng, n: int) -> None:
    """d/<species>/: n WAVs of each species in PRIORITY_ORDER, one clip of
    ``cfg`` each at 48 kHz PCM16, the species' band with its centre jittered
    per file."""
    from anuraxla_torch.constants import PRIORITY_ORDER
    from anuraxla_torch.utils.wavio import write_wav

    t = np.arange(cfg.num_samples) / cfg.sr
    for sp, f0 in zip(PRIORITY_ORDER, BANDS):
        (d / sp).mkdir(parents=True)
        for i in range(n):
            f = f0 * (1 + 0.05 * rng.standard_normal())
            write_wav(d / sp / f"{sp}_{i:03d}.wav", tone_chunk(t, rng, f), cfg.sr)


def write_tree(root: Path, cfg, rng) -> list:
    """root/chunks/<species>/: FIT_FILES WAVs of each species (5 s at 48 kHz
    PCM16, each species a tone band of its own, gated on and off, plus
    noise); and six held-out WAVs beside it: one from each band, one out of
    every band, one of noise. -> the held-out paths."""
    from anuraxla_torch.utils.wavio import write_wav

    write_species_files(root / "chunks", cfg, rng, FIT_FILES)
    t = np.arange(cfg.num_samples) / cfg.sr
    held = []
    for i, f in enumerate(BANDS + (12000.0, 0.0)):
        held.append(root / f"held_{i}.wav")
        write_wav(held[-1], tone_chunk(t, rng, f), cfg.sr)
    return held


def row_rel_err(a: np.ndarray, b: np.ndarray) -> float:
    """max |a − b| of each row over that row's max |b|, the worst row."""
    return float((np.abs(a - b).max(axis=1) / np.abs(b).max(axis=1)).max())


def copy_route(sess, paths) -> None:
    """``encode_paths`` as it ran before the native decoder: the Python
    reader into a new array for each batch, then a copy into the pinned slot
    (``_to_device`` copies rows it does not hold) and the transfer, two
    batches in flight."""
    from anuraxla_torch.pipeline.dataset import iter_batches

    pending = None
    for batch, _ in iter_batches(paths, sr=sess.mel.sr, num_samples=sess.mel.num_samples,
                                 batch_size=sess.batch_size, num_threads=sess.num_threads, use_native=False,
                                 layout=sess._layout):
        cur = sess._dispatch(batch.audio)
        if pending is not None:
            pending.cpu()
        pending = cur
    pending.cpu()


def host_split(sess, paths, route: str, reps: int = 2) -> dict:
    """One batch's host side, each step timed on its own (the fastest of
    ``reps``): decode (the Python reader into a new array, or the native
    decoder into the pinned slot), copy (the Python route's copy into the
    pinned slot; with ``transfer_int16`` the PCM16 conversion into the int16
    slot; none on the native route) and transfer (the non-blocking copy to
    the card, synchronized). -> {step: ms}."""
    from anuraxla_torch.pipeline.dataset import load_wav_batch
    from anuraxla_torch.pipeline.session import to_pcm16

    B, (row_len, off) = sess.batch_size, sess._layout
    kw = dict(sr=sess.mel.sr, num_samples=sess.mel.num_samples, num_threads=sess.num_threads, layout=sess._layout)
    f32 = sess._ring((B, row_len), torch.float32)
    best = {}
    for _ in range(reps):
        t0 = time.perf_counter()
        if route == "python":
            rows = load_wav_batch(paths[:B], use_native=False, **kw).audio
        else:
            rows = f32.claim()
            load_wav_batch(paths[:B], out=rows, **kw)
        t1 = time.perf_counter()
        if route == "python":
            ring, slot = f32, f32.claim()
            slot[...] = rows
        elif route == "native-int16":
            ring = sess._ring((B, row_len), torch.int16)
            slot = ring.claim()
            to_pcm16(rows, slot)  # as EncoderSession._to_device converts
        else:
            ring, slot = f32, rows
        t2 = time.perf_counter()
        ring.send(slot)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in (("decode", t1 - t0), ("copy", t2 - t1), ("transfer", t3 - t2)):
            best[k] = min(best.get(k, np.inf), v * 1e3)
    return best


def phase_fit_path(seed: int, rng, root: Path) -> dict:
    """This slice's main path at full width (``DEFAULT_MEL``, default
    ``VAEConfig``, balanced tier, pre-padded host rows): a synthetic species
    tree encoded through the native decoder and ``mel_power_ct``, the radial
    fit and two MAP fits (LDA full; QDA diag, shrink 0.1) on the card, the
    species-tree cache read back, and both detectors served from the written
    config.json through the CLIs' ``main`` — launch counts and decode routes
    set to 0 just before, read just after. The same fits on the CPU from the
    card's latents are held to the card's; the CLIs' exit codes to the CPU
    fits' decisions. Then ``encode_paths`` timed at B = 1024 over 4096 paths
    by three decode routes, with the host side split. -> {"launches":
    launches of mel_power_ct on the path, "chunks_per_s": {route: ...}}."""
    import argparse as ap

    from anuraxla_torch.cli import evaluate_wav, evaluate_wav_map
    from anuraxla_torch.cli.common import session_kwargs
    from anuraxla_torch.config import priority_ranks
    from anuraxla_torch.constants import DEFAULT_MEL as cfg
    from anuraxla_torch.constants import PRIORITY_ORDER
    from anuraxla_torch.detect.gaussian_map import fit_map, map_decide
    from anuraxla_torch.detect.radial import fit_radial, radial_decide
    from anuraxla_torch.models.checkpoint import save_encoder
    from anuraxla_torch.models.vae import VAEConfig, init_encoder_params
    from anuraxla_torch.ops.mel_kernel import mel_power, reset_launches
    from anuraxla_torch.pipeline.dataset import load_wav_batch
    from anuraxla_torch.pipeline.fit import fit_map_tree, fit_radial_tree
    from anuraxla_torch.pipeline.session import EncoderSession, encode_species_tree
    from anuraxla_torch.probes.common import card_line

    smi = card_line()
    out = {"chunks_per_s": {}}
    t0 = time.perf_counter()
    held = write_tree(root, cfg, rng)
    enc_dir = save_encoder(root / "encoder", VAEConfig(), init_encoder_params(
        VAEConfig(), torch.Generator().manual_seed(seed + 6)))
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps({"species": list(PRIORITY_ORDER), "chunk_seconds": cfg.duration}))
    log(f"[fit-path] tree of {len(PRIORITY_ORDER)} species x {FIT_FILES} WAVs (5 s, 48 kHz, PCM16) + "
        f"{len(held)} held out, encoder artifact by save_encoder: {time.perf_counter() - t0:.2f} s")

    balanced = session_kwargs(ap.Namespace(serving_tier="balanced", batch_size=64, io_threads=8,
                                           pre_padded_host=True))
    sess = EncoderSession(mel=cfg, encoder_dir=enc_dir, project_root=root, **balanced).load()
    lines = []
    fit_kw = dict(cfg_path=cfg_path, chunks_dir=root / "chunks", session=sess, cache=True,
                  cache_dir=root / "cache", max_per_class=0, seed=123, log=lines.append)
    map_kw = dict(priors_mode="empirical", eps=1e-6, tau_q=0.01)

    reset_launches()  # count only the fit path from here
    routes0 = dict(load_wav_batch.routes)
    t0 = time.perf_counter()
    radial = fit_radial_tree(cfg=json.loads(cfg_path.read_text()), q_in=0.95, q_out=0.01, **fit_kw)
    t_radial_tree = time.perf_counter() - t0
    lda = fit_map_tree(cfg=json.loads(cfg_path.read_text()), cov_type="lda", cov_structure="full", shrink=0.0,
                       **map_kw, **fit_kw)
    qda = fit_map_tree(cfg=json.loads(cfg_path.read_text()), cov_type="qda", cov_structure="diag", shrink=0.1,
                       **map_kw, **fit_kw)
    again, _, _ = encode_species_tree(sess, root / "chunks", PRIORITY_ORDER, cache=True, cache_dir=root / "cache",
                                      log=lines.append)
    cached = sum("🧊" in line for line in lines)
    for line in lines:
        if line.startswith("✅") or "encoded N=" in line:
            log(f"[fit-path]   {line}")
    if cached != 3 * len(PRIORITY_ORDER):
        raise AssertionError(f"fit path: {cached} species read back from the cache, not {3 * len(PRIORITY_ORDER)}")
    for i, sp in enumerate(radial["species"]):
        if not np.array_equal(again[sp], radial["Z"][i][radial["mask"][i]]):
            raise AssertionError(f"fit path: {sp}'s cached latents differ from the encoded ones")

    # serving from the written file: the radial block (fit_radial_tree) and
    # the MAP block (the QDA fit, written last)
    exits = {}
    for name, main, argv in (("evaluate_wav", evaluate_wav.main, ["--serving-tier", "balanced"]),
                             ("evaluate_wav_map", evaluate_wav_map.main, [])):
        exits[name] = []
        for wav in held:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                try:
                    main(["--wav", str(wav), "--config", str(cfg_path), "--encoder", str(enc_dir), *argv])
                except SystemExit as e:
                    exits[name].append(e.code)
            log(f"[fit-path]   {name} {wav.name}: {buf.getvalue().strip()} (exit {exits[name][-1]})")
    torch.cuda.synchronize()
    counts = dict(mel_power.launches)
    routes = {k: load_wav_batch.routes[k] - routes0[k] for k in routes0}
    log(f"[fit-path] fit_radial_tree ({t_radial_tree:.2f} s with the encode), fit_map_tree x 2 and "
        f"encode_species_tree from the cache, {len(held)} WAVs x 2 CLIs: launches {counts}; decode routes {routes}")
    if counts["mel_power_ct"] <= 0:
        raise AssertionError("the fit path did not launch mel_power_ct")
    if routes["native"] <= 0 or routes["python"]:
        raise AssertionError(f"the fit path did not decode through the native decoder alone: {routes}")
    out["launches"] = counts["mel_power_ct"]

    # the same fits on the CPU, from the card's latents
    def on(dev, *arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    Zr, mr = on("cpu", radial["Z"], radial["mask"])
    cpu_r = fit_radial(Zr, mr, 0.95, 0.01)
    card_r = radial["fit"]
    flat = radial["Z"][radial["mask"]]
    ranks = priority_ranks(radial["species"])
    errs = {"centroids": row_rel_err(card_r.centroids.cpu().numpy(), cpu_r.centroids.numpy()),
            "rk": float((card_r.rk.cpu() / cpu_r.rk - 1).abs().max())}
    dec_card = [v.cpu() for v in radial_decide(*on("cuda", flat), card_r.centroids, card_r.rk,
                                               *on("cuda", ranks))]
    dec_cpu = radial_decide(*on("cpu", flat), cpu_r.centroids, cpu_r.rk, *on("cpu", ranks))
    same = [bool(torch.equal(dec_card[0], dec_cpu[0]) and torch.equal(dec_card[1], dec_cpu[1]))]
    cpu_maps = {}
    for name, res, kw in (("lda", lda, dict(cov_type="lda", cov_structure="full", shrink=0.0)),
                          ("qda", qda, dict(cov_type="qda", cov_structure="diag", shrink=0.1))):
        cpu_m = cpu_maps[name] = fit_map(*on("cpu", res["Z"], res["mask"]), **kw, **map_kw)
        card_m = res["fit"]
        errs[f"{name} means"] = row_rel_err(card_m.means.cpu().numpy(), cpu_m.means.numpy())
        errs[f"{name} logdets"] = float((card_m.logdets.cpu() / cpu_m.logdets - 1).abs().max())
        errs[f"{name} tau"] = abs(float(card_m.tau) / float(cpu_m.tau) - 1)
        zf = res["Z"][res["mask"]]
        dc = map_decide(*on("cuda", zf), card_m.means, card_m.precisions, card_m.logdets, card_m.priors, card_m.tau)
        dp = map_decide(*on("cpu", zf), cpu_m.means, cpu_m.precisions, cpu_m.logdets, cpu_m.priors, cpu_m.tau)
        same.append(bool(torch.equal(dc[0].cpu(), dp[0]) and torch.equal(dc[1].cpu(), dp[1])))
        log(f"[fit-path] {name}: {int(dp[0].sum())} of {len(zf)} training latents detected; tau card "
            f"{float(card_m.tau):.6f}, CPU {float(cpu_m.tau):.6f}")
    log(f"[fit-path] card vs CPU fit on the card's latents, relative errors: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (gates {FIT_RTOL} / {FIT_RTOL_LOGDET}); decisions identical on every training latent "
        f"(radial, lda, qda): {same}; radial detects {int(dec_cpu[0].sum())} of {len(flat)}")
    gates = {k: (FIT_RTOL_LOGDET if ("logdet" in k or "tau" in k) else FIT_RTOL) for k in errs}
    bad = {k: v for k, v in errs.items() if not v <= gates[k]}
    if bad or not all(same):
        raise AssertionError(f"the card's fits disagree with the CPU's: {bad}, decisions identical {same}")

    # the CLIs' exit codes against the CPU fits' decisions on the same latents
    Zh = {}
    for name, kw in (("evaluate_wav", dict(balanced, pre_padded_host=False)), ("evaluate_wav_map", {})):
        s = EncoderSession(mel=cfg, encoder_dir=enc_dir, project_root=root, **dict(kw, batch_size=1)).load()
        Zh[name], ok, err = s.encode_paths(held)
        if not ok.all():
            raise AssertionError(f"held-out WAVs: {err}")
    det_r = radial_decide(torch.from_numpy(Zh["evaluate_wav"]), cpu_r.centroids, cpu_r.rk,
                          torch.from_numpy(ranks))[0]
    m = cpu_maps["qda"]
    det_m = map_decide(torch.from_numpy(Zh["evaluate_wav_map"]), m.means, m.precisions, m.logdets, m.priors,
                       m.tau)[0]
    want = {"evaluate_wav": [0 if d else 2 for d in det_r.tolist()],
            "evaluate_wav_map": [0 if d else 2 for d in det_m.tolist()]}
    log(f"[fit-path] exit codes {exits}; the CPU fits' decisions {want}")
    if exits != want:
        raise AssertionError(f"served exit codes {exits} differ from the CPU fits' decisions {want}")

    # the fits alone on the card, the second call of each (the first builds cuSOLVER's handles)
    Zc, mc = on("cuda", qda["Z"], qda["mask"])
    fit_ms = {}
    for name, fn in (("fit_radial", lambda: fit_radial(Zc, mc, 0.95, 0.01)),
                     ("fit_map lda full", lambda: fit_map(Zc, mc, cov_type="lda", cov_structure="full", **map_kw)),
                     ("fit_map qda diag", lambda: fit_map(Zc, mc, cov_type="qda", cov_structure="diag",
                                                           shrink=0.1, **map_kw))):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            fit_ms[name] = (time.perf_counter() - t0) * 1e3
    log(f"[times] fits on the card, {int(mc.sum())} latents of 128 dims in {mc.shape[0]} species (host clock, "
        f"synchronized): " + ", ".join(f"{k} {v:.2f} ms" for k, v in fit_ms.items()) + f"; {smi}")

    # encode_paths at B = 1024 over 4096 paths: the tree's files listed
    # again and again, so after the first pass they sit in the page cache
    files = sorted((root / "chunks").rglob("*.wav"))
    paths = [files[i % len(files)] for i in range(FIT_TIMING_PATHS)]
    kw = dict(balanced, batch_size=TIMING_B)
    for label, split_route, i16, fn in (("python reader + copy", "python", False, copy_route),
                                         ("native into pinned", "native", False, None),
                                         ("native + transfer_int16", "native-int16", True, None)):
        s = EncoderSession(mel=cfg, encoder_dir=enc_dir, project_root=root, **dict(kw, transfer_int16=i16)).load()
        run = (lambda ps: fn(s, ps)) if fn else s.encode_paths
        run(paths[:TIMING_B])  # warm-up: the pinned slots, cuDNN's choices, the page cache
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(paths)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out["chunks_per_s"][label] = FIT_TIMING_PATHS / dt
        split = host_split(s, paths, split_route)
        log(f"[times] encode_paths {label}, balanced tier, B={TIMING_B} x {FIT_TIMING_PATHS // TIMING_B} batches "
            f"(pre-padded rows, {'int16' if i16 else 'f32'} on the link; files in the page cache): "
            f"{dt:.3f} s = {FIT_TIMING_PATHS / dt:.1f} chunks/s; one batch's host side alone: "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items()) + f"; {smi}")
        del s
        torch.cuda.empty_cache()
    return out


EVAL_FILES = 48  # val WAVs of each species in the evaluation phase's tree
SCAN_FILES, SCAN_SECONDS, SCAN_HOP_S = 4, 600, 2.5  # the fleet: 4 recordings x 10 min, a window every 2.5 s
SCAN_CALLS = (50, 180, 310, 440)  # each recording's planted calls start here (s): 10 s of one species' band
SCAN_CALL_S = 10
SCAN_PARITY_ROWS = 32  # windows whose parity-tier latents are held to the CPU session
# a window inside a planted call is an in-distribution sample of its species, which the fit's radius
# (q_in 0.95) holds about 95 % of; a window of noise alone lies outside every band's radius
SCAN_HIT_SHARE, SCAN_FALSE_SHARE = 0.85, 0.05
EVAL_RTOL = 1e-5  # the device sweep's thresholds, card vs CPU from the same latents and fit
TAU_RTOL = 1e-4  # calibrate-tau's taus, the card's MAP fit vs the CPU's from the same latents


def write_recordings(d: Path, cfg, rng) -> dict:
    """d/raw/site<r>/rec.wav: SCAN_FILES recordings of SCAN_SECONDS at 48 kHz
    PCM16 mono, noise with a call planted at each of SCAN_CALLS (two 5 s
    chunks of one species' band, species (r + j) % 4); d/norm/site<r>/rec.wav:
    the same samples scaled to RMS 0.05. Every file has the same name, so the
    fleet scan must key its outputs by the root-relative path. -> {site:
    [(start s, species index)]}."""
    from anuraxla_torch.utils.wavio import write_wav

    t = np.arange(cfg.num_samples) / cfg.sr
    planted = {}
    for r in range(SCAN_FILES):
        y = 0.02 * rng.standard_normal(SCAN_SECONDS * cfg.sr).astype(np.float32)
        planted[f"site{r}"] = []
        for j, start in enumerate(SCAN_CALLS):
            k = (r + j) % len(BANDS)
            for c in range(SCAN_CALL_S // 5):
                a = (start + 5 * c) * cfg.sr
                y[a : a + t.size] = tone_chunk(t, rng, BANDS[k] * (1 + 0.05 * rng.standard_normal()))
            planted[f"site{r}"].append((start, k))
        for kind, scale in (("raw", 1.0), ("norm", 0.05 / np.sqrt(np.mean(y.astype(np.float64) ** 2)))):
            (d / kind / f"site{r}").mkdir(parents=True)
            write_wav(d / kind / f"site{r}" / "rec.wav", y * np.float32(scale), cfg.sr)
    return planted


def phase_eval_path(seed: int, root: Path) -> dict:
    """The evaluation path at full width (``DEFAULT_MEL``, default
    ``VAEConfig``, balanced tier, pre-padded host rows) on the fit phase's
    project (its encoder artifact and the config.json with the radial and MAP
    blocks it wrote), through the ``main`` of each CLI, from the project root,
    with the launch counts set to 0 just before each step and read just after:
    ``benchmark-folder`` and ``benchmark-folder-map`` on a val tree of 4
    species x 48 WAVs and one truncated WAV, the SNR sweep, ``run-qout-grid``
    (per-point refits and benchmarks, the 3 x 4 device sweep with a noise
    margin, the Spearman analysis), ``calibrate-tau --set-best`` (QDA diag,
    shrink 0.1: a full covariance of 128 dims from 48 files a species rejects
    every val file) and the fleet scan (``scan-soundscape --root``, 4
    recordings x 10 min with planted calls, hop 2.5 s: once with the RMS fused
    into the mel kernel, once with ``--no-normalize`` on the same audio
    pre-normalized). Each result is held to the
    same computation on the CPU from the card's latents. -> {"launches":
    {kernel: launches on the path}, "times": {...}}."""
    import argparse as ap
    import csv

    from anuraxla_torch.cli import (
        benchmark_folder, benchmark_folder_map, calibrate_tau, run_qout_grid, scan_soundscape,
    )
    from anuraxla_torch.cli.common import session_kwargs
    from anuraxla_torch.cli.spearman_analysis import parse_summary
    from anuraxla_torch.config import load_config, priority_ranks, read_map, read_radial
    from anuraxla_torch.constants import CACHE_DIR_NAME
    from anuraxla_torch.constants import DEFAULT_MEL as cfg
    from anuraxla_torch.constants import PRIORITY_ORDER
    from anuraxla_torch.detect.calibrate import map_tau_sweep, radial_qgrid
    from anuraxla_torch.detect.gaussian_map import fit_map, map_decide
    from anuraxla_torch.detect.radial import RadialFit, fit_radial, radial_decide
    from anuraxla_torch.ops.mel_kernel import mel_power, reset_launches
    from anuraxla_torch.pipeline.benchmark import run_folder_benchmark
    from anuraxla_torch.pipeline.fit import encode_augmented_tree
    from anuraxla_torch.pipeline.session import (
        EncoderSession, concat_species_latents, encode_species_tree, pad_species_latents,
    )
    from anuraxla_torch.pipeline.stream import fleet_window_batches, scan_soundscapes
    from anuraxla_torch.probes.common import card_line
    from anuraxla_torch.utils.wavio import WavStream

    smi = card_line()
    rng = np.random.default_rng([seed, 7])
    enc_dir, cfg_path, chunks, val = root / "encoder", root / "config.json", root / "chunks", root / "val"
    t0 = time.perf_counter()
    write_species_files(val, cfg, rng, EVAL_FILES)
    first = sorted((val / PRIORITY_ORDER[0]).glob("*.wav"))[0]
    (val / PRIORITY_ORDER[0] / "zz_truncated.wav").write_bytes(first.read_bytes()[:30])
    planted = write_recordings(root / "recs", cfg, rng)
    log(f"[eval-path] val tree of {len(PRIORITY_ORDER)} species x {EVAL_FILES} WAVs + 1 truncated, and "
        f"{SCAN_FILES} recordings x {SCAN_SECONDS // 60} min (x 2: raw and pre-normalized): "
        f"{time.perf_counter() - t0:.2f} s")

    tier = ["--config", str(cfg_path), "--encoder", str(enc_dir), "--serving-tier", "balanced", "--pre-padded-host",
            "--io-threads", "8"]
    balanced = session_kwargs(ap.Namespace(serving_tier="balanced", batch_size=64, io_threads=8, pre_padded_host=True))
    launches = dict.fromkeys(KERNELS, 0)
    times = {}

    def step(name: str, main, argv: list) -> str:
        """One CLI run, launch counts set to 0 just before and read just
        after; -> its standard output (also logged)."""
        buf = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(mel_power.launches)
        for line in buf.getvalue().splitlines():
            if line.startswith(("✅", "⏱️", "🎯", "💾 on-device", "⚠️", "GLOBAL", "- ")) or "windows" in line:
                log(f"[eval-path]   {line.replace(str(root), '<project>')}")
        log(f"[eval-path] {name}: {dt:.2f} s; launches {counts}")
        if counts["mel_power_ct"] <= 0:
            raise AssertionError(f"eval path, {name}: mel_power_ct was not launched")
        if any(counts[k] for k in FUSED):
            raise AssertionError(f"eval path, {name}: a serving path launched the study's split kernel: {counts}")
        for k in launches:
            launches[k] += counts[k]
        times[f"{name} s"] = dt
        return buf.getvalue()

    def read_csv(path):
        with open(path, newline="", encoding="utf-8") as f:
            return list(csv.DictReader(f))

    def on(dev, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    with contextlib.chdir(root):  # the project root: outputs/ and the latent cache land in it
        sess = EncoderSession(mel=cfg, encoder_dir=enc_dir, project_root=root, **balanced).load()
        cfg0 = load_config(cfg_path)

        # folder benchmarks; every decision recomputed on the CPU from the card's latents
        for name, main, detector in (("benchmark-folder", benchmark_folder.main, "radial"),
                                     ("benchmark-folder-map", benchmark_folder_map.main, "map")):
            out_dir = root / f"bench_{detector}"
            step(name, main, ["--root", str(val), "--out-dir", str(out_dir), "--batch-size", "64", *tier])
            rows = read_csv(out_dir / "results.csv")
            errors = [r for r in rows if r["pred_species"] == "ERROR"]
            if len(errors) != 1 or not errors[0]["file"].endswith("zz_truncated.wav") or not errors[0]["error"]:
                raise AssertionError(f"{name}: the truncated WAV is not the one ERROR row: {errors}")
            acc, nd, acc_sp, _ = parse_summary(out_dir / "summary.txt")
            Z, ok, _ = sess.encode_paths([Path(r["file"]) for r in rows])
            if list(ok) != [r["pred_species"] != "ERROR" for r in rows]:
                raise AssertionError(f"{name}: decode failures differ from the ERROR rows")
            if detector == "radial":
                species, cents, thr, _ = read_radial(cfg0)
                det, win, _ = radial_decide(*on("cpu", Z[ok], cents, thr, priority_ranks(species)))
            else:
                species, means, precs, lds, priors, tau, _ = read_map(cfg0)
                det, win, _ = map_decide(*on("cpu", Z[ok], means, precs, lds, priors),
                                         torch.tensor(float("nan") if tau is None else tau))
            cpu_pred = [species[int(w)] if d else "NO_DETECT" for d, w in zip(det.tolist(), win.tolist())]
            card_pred = [r["pred_species"] for r in rows if r["pred_species"] != "ERROR"]
            log(f"[eval-path] {name}: accuracy {acc * 100:.2f} %, NO_DETECT {nd * 100:.2f} % over "
                f"{len(card_pred)} WAVs ({len(acc_sp)} species); CPU decisions from the card's latents "
                f"identical: {cpu_pred == card_pred}")
            if cpu_pred != card_pred:
                raise AssertionError(f"{name}: the card's decisions differ from the CPU's on the card's latents")
            if detector == "radial":
                plain_acc = sum(r["pred_species"] == r["true_species"] for r in rows if r["pred_species"] != "ERROR")
                plain_acc /= len(card_pred)
        res = run_folder_benchmark(root=val, config_path=cfg_path, detector="radial", session=sess,
                                   out_dir=root / "bench_warm", log=lambda *a: None, write_artifacts=False)
        times["run_folder_benchmark encode chunks/s (warm session, batch 64)"] = res.encode_rate
        log(f"[times] run_folder_benchmark, balanced tier, batch 64, {res.total + 1} WAVs (5 s, 48 kHz, files in "
            f"the page cache), warm session: encode {res.encode_rate:.1f} chunks/s; {smi}")

        # the SNR sweep: the clean point is the plain benchmark
        step("benchmark-folder --snr-sweep", benchmark_folder.main,
             ["--root", str(val), "--out-dir", str(root / "snr"), "--snr-sweep", "clean,20,8", "--batch-size", "64",
              *tier])
        curve = read_csv(root / "snr" / "snr_curve.csv")
        log(f"[eval-path] snr_curve.csv: {curve}")
        if len(curve) != 3 or curve[0]["snr_db"] != "" or float(curve[0]["accuracy"]) != plain_acc:
            raise AssertionError(f"SNR sweep: {curve}; the clean point must equal the benchmark's {plain_acc}")

        # the q_out grid, in process, with the device sweep and the Spearman analysis
        q_out_grid, q_in_grid = ["0.10", "0.15", "0.20", "0.25"], ["0.90", "0.95", "0.99"]
        grid = root / "grid"
        out = step("run-qout-grid", run_qout_grid.main,
                   ["--train-root", str(chunks), "--val-root", str(val), "--grid-root", str(grid), "--q-out-grid",
                    *q_out_grid, "--device-sweep", "--q-in-grid", *q_in_grid, "--noise-margin-db", "14",
                    "--analyze", "--batch-size", "64", *tier])
        point_s = [float(x) for x in re.findall(r"⏱️ grid point q_out=\S+: ([0-9.]+)s", out)]
        for q in q_out_grid:
            d = grid / f"qout_{q}"
            missing = [n for n in ("summary.txt", "results.csv", "config_used.json", "config_snapshot.json")
                       if not (d / n).is_file()]
            snap = json.loads((d / "config_snapshot.json").read_text()) if not missing else {}
            if missing or sorted(snap.get("rk_per_species", {})) != sorted(PRIORITY_ORDER):
                raise AssertionError(f"run-qout-grid: {d.name} lacks {missing} or rk of every species: {snap}")
        if not (grid / "spearman_table.csv").is_file() or len(point_s) != len(q_out_grid):
            raise AssertionError("run-qout-grid: no spearman_table.csv, or not one timed grid point each")
        gm_rows = read_csv(grid / "grid_metrics.csv")
        # the same sweep on the CPU from the card's latents (the grid's cache) and the card's fit
        Z_by, _, _ = encode_augmented_tree(sess, chunks, list(PRIORITY_ORDER), augment_noise_db=[], cache=True,
                                           cache_dir=root / CACHE_DIR_NAME, max_per_class=400, seed=123,
                                           log=lambda *a: None)
        species, Z, mask = pad_species_latents(Z_by)
        card_fit = fit_radial(*on("cuda", Z, mask), 0.95, 0.10)
        Zv_by, _, _ = encode_species_tree(sess, val, species, log=lambda *a: None)
        Zv, ti = concat_species_latents(Zv_by, species)
        ranks = priority_ranks(species)
        qi, qo = np.float32(q_in_grid), np.float32(q_out_grid)
        args_card = on("cuda", Zv, ti, ranks)
        radial_qgrid(card_fit, *args_card, qi, qo)  # warm-up
        sweep_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gm_card = radial_qgrid(card_fit, *args_card, qi, qo)
            torch.cuda.synchronize()
            sweep_ms.append((time.perf_counter() - t0) * 1e3)
        cpu_fit = RadialFit(**{f.name: getattr(card_fit, f.name).cpu() for f in dataclasses.fields(RadialFit)})
        gm_cpu = radial_qgrid(cpu_fit, *on("cpu", Zv, ti, ranks), qi, qo)
        thr_err = float((gm_card.thresholds.cpu() / gm_cpu.thresholds - 1).abs().max())
        csv_acc = np.array([[float(r["val_accuracy"]), float(r["val_no_detect_rate"])] for r in gm_rows])
        cpu_acc = np.stack([gm_cpu.accuracy.numpy().ravel(), gm_cpu.no_detect_rate.numpy().ravel()], axis=1)
        same = np.array_equal(csv_acc, cpu_acc) and torch.equal(gm_card.acc_per_class.cpu(), gm_cpu.acc_per_class)
        summary_acc = {q: parse_summary(grid / f"qout_{q}" / "summary.txt")[0] for q in q_out_grid}
        at95 = {q: float(gm_cpu.accuracy[q_in_grid.index("0.95"), j]) for j, q in enumerate(q_out_grid)}
        agree95 = all(f"{at95[q] * 100:.2f}" == f"{summary_acc[q] * 100:.2f}" for q in q_out_grid)
        log(f"[eval-path] device sweep {len(q_in_grid)} x {len(q_out_grid)}: grid_metrics.csv vs the CPU sweep from "
            f"the card's latents and fit: rates identical {same}, thresholds card vs CPU {thr_err:.3e} "
            f"(gate {EVAL_RTOL}); accuracy at q_in 0.95 {at95} vs the per-point summaries {summary_acc}: "
            f"equal at two decimals {agree95}")
        if not same or not thr_err <= EVAL_RTOL or not agree95:
            raise AssertionError("run-qout-grid: the device sweep disagrees with the CPU or the per-point benchmark")
        times["device sweep 3x4 ms"] = min(sweep_ms)
        times["grid point s"] = point_s
        log(f"[times] device sweep, {len(q_in_grid)} x {len(q_out_grid)} grid over {len(ti)} val latents: "
            f"{min(sweep_ms):.3f} ms (the fastest of 5, host clock, synchronized); wall s per grid point (refit "
            f"from the cache + benchmark of {len(ti) + 1} WAVs): {point_s}; {smi}")

        # calibrate-tau, held to map_tau_sweep on the CPU from the card's latents
        tau_csv = root / "tau_grid.csv"
        step("calibrate-tau", calibrate_tau.main,
             ["--train-root", str(chunks), "--val-root", str(val), "--out", str(tau_csv), "--set-best",
              "--cov-type", "qda", "--cov-structure", "diag", "--shrink", "0.1", "--batch-size", "64", *tier])
        tau_rows = read_csv(tau_csv)
        Zt_by, _, _ = encode_species_tree(sess, chunks, list(PRIORITY_ORDER), log=lambda *a: None)
        species_t, Zt, mt = pad_species_latents({sp: Zt_by[sp] for sp in sorted(Zt_by)})
        Zv_by, _, _ = encode_species_tree(sess, val, species_t, log=lambda *a: None)
        Zv, ti = concat_species_latents(Zv_by, species_t)
        mfit = fit_map(*on("cpu", Zt, mt), cov_type="qda", cov_structure="diag", shrink=0.1, eps=1e-6)
        qs = [float(r["tau_q"]) for r in tau_rows]
        taus, acc, nod = map_tau_sweep(mfit.scores_true_sorted, mfit.n_scores, *on("cpu", Zv, ti), mfit.means,
                                       mfit.precisions, mfit.logdets, mfit.priors, qs)
        tau_err = float(np.abs(np.array([float(r["tau"]) for r in tau_rows]) / taus.numpy() - 1).max())
        same = ([float(r["val_accuracy"]) for r in tau_rows] == acc.tolist()
                and [float(r["val_no_detect_rate"]) for r in tau_rows] == nod.tolist())
        new_tau = load_config(cfg_path)["map_detector"]["tau"]
        log(f"[eval-path] tau_grid.csv vs map_tau_sweep on the CPU from the card's latents: taus {tau_err:.3e} "
            f"(gate {TAU_RTOL}), rates identical {same}; accuracies {acc.tolist()}; tau set to {new_tau}")
        if not tau_err <= TAU_RTOL or not same or not max(acc.tolist()) > 0.5 or not (root / "config.json.bak").is_file():
            raise AssertionError("calibrate-tau disagrees with the CPU sweep, or wrote no backup")

        # the fleet scan: 4 recordings x 10 min at hop 2.5 s = 960 windows, one batch of 1024, served
        # by the fit phase's radial block (q_out 0.01), not the grid's last point (q_out 0.25)
        cfg_path.write_text(json.dumps(cfg0))
        recs = root / "recs" / "raw"
        scan_args = ["--hop-seconds", str(SCAN_HOP_S), "--batch-size", str(TIMING_B), *tier]
        for name, d, extra in (("scan-soundscape", recs, ["--extract-dir", str(root / "extract")]),
                               ("scan-soundscape --no-normalize", root / "recs" / "norm", ["--no-normalize"])):
            out_dir = root / ("det" if d == recs else "det_norm")
            step(name, scan_soundscape.main, ["--root", str(d), "--out", str(out_dir), *extra, *scan_args])
            rows_by_site = {site: read_csv(out_dir / f"{site}__rec.detections.csv") for site in planted}
            n_rows = sum(len(v) for v in rows_by_site.values())
            hits = inside = false = outside = 0
            for site, calls in planted.items():
                for r in rows_by_site[site]:
                    t0, t1 = float(r["t_start"]), float(r["t_end"])
                    k = next((k for start, k in calls if start <= t0 and t1 <= start + SCAN_CALL_S), None)
                    if k is not None:
                        inside += 1
                        hits += r["species"] == PRIORITY_ORDER[k]
                    elif any(t0 < start + SCAN_CALL_S and start < t1 for start, _ in calls):
                        continue  # holds part of a call
                    else:
                        outside += 1
                        false += r["detected"] == "True"
            log(f"[eval-path] {name}: {n_rows} windows; of the {inside} windows inside a planted call {hits} "
                f"detected as its species (gate {SCAN_HIT_SHARE:.0%}); of the {outside} windows of noise alone "
                f"{false} detected (gate {SCAN_FALSE_SHARE:.0%})")
            if n_rows != SCAN_FILES * int(SCAN_SECONDS / SCAN_HOP_S):
                raise AssertionError(f"{name}: {n_rows} windows")
            if hits < SCAN_HIT_SHARE * inside or false > SCAN_FALSE_SHARE * outside:
                raise AssertionError(f"{name}: planted calls missed or noise detected")
        extracted = sorted((root / "extract").rglob("*.wav"))
        scanned = sum(r["detected"] == "True" for site in planted
                      for r in read_csv(root / "det" / f"{site}__rec.detections.csv"))
        if len(extracted) != scanned or {p.name.split("_t")[0] for p in extracted} != {f"{s}__rec" for s in planted}:
            raise AssertionError(f"--extract-dir wrote {len(extracted)} chunks for {scanned} detections")

        # the first batch again through encode_array on the card: the same decisions
        wavs = sorted(recs.rglob("*.wav"))
        scan_kw = dict(mel=cfg, encoder_dir=enc_dir, project_root=root, normalize_on_device=True,
                       **dict(balanced, batch_size=TIMING_B))
        ssess = EncoderSession(**scan_kw).load()
        hop = int(cfg.sr * SCAN_HOP_S)
        batch, tags, n_valid = next(iter(fleet_window_batches(
            [WavStream(p) for p in wavs], num_samples=cfg.num_samples, hop_samples=hop, batch_size=TIMING_B,
            target_sr=cfg.sr, layout=ssess._layout)))
        cfg1 = load_config(cfg_path)
        species, cents, thr, _ = read_radial(cfg1)
        det, win, best = (x.cpu() for x in radial_decide(torch.from_numpy(ssess.encode_array(batch)).cuda(),
                                                          *on("cuda", cents, thr, priority_ranks(species))))
        again = [species[int(w)] if d else "NO_DETECT" for d, w in zip(det.tolist(), win.tolist())][:n_valid]
        scanned = [r["species"] for p in wavs for r in read_csv(root / "det" / f"{p.parent.name}__rec.detections.csv")]
        log(f"[eval-path] first batch ({n_valid} windows) through encode_array on the card: decisions identical "
            f"to the scan's {again == scanned[:n_valid]}")
        if again != scanned[:n_valid]:
            raise AssertionError("the scan's detections differ from encode_array's on the same windows")
        # the parity tier's latents for 32 windows around the first planted call, card vs CPU
        i0 = max(0, int(np.searchsorted(tags[:n_valid, 1], SCAN_CALLS[0] * cfg.sr)) - 8)
        rows = np.ascontiguousarray(batch[i0 : i0 + SCAN_PARITY_ROWS])
        parity = session_kwargs(ap.Namespace(serving_tier="parity", batch_size=SCAN_PARITY_ROWS, io_threads=8,
                                             pre_padded_host=True))
        pkw = dict(mel=cfg, encoder_dir=enc_dir, project_root=root, normalize_on_device=True, **parity)
        Zp = EncoderSession(**pkw).load().encode_array(rows)
        Zc = EncoderSession(**pkw, device="cpu").load().encode_array(rows)
        np.testing.assert_allclose(Zp, Zc, rtol=5e-4, atol=2e-5)
        log(f"[eval-path] parity tier, {SCAN_PARITY_ROWS} scan windows (fused RMS, pre-padded) card vs CPU: "
            f"max|diff| {np.abs(Zp - Zc).max():.3e} (rtol 5e-4, atol 2e-5)")

        # the scan timed on a warm session, and its parts
        for _ in range(2):  # the first run warms the page cache and the allocator
            torch.cuda.synchronize()
            _, stats = scan_soundscapes(wavs, ssess, detector="radial", config=cfg1, hop_seconds=SCAN_HOP_S,
                                        log=lambda *a: None)
        t0 = time.perf_counter()
        batch1 = next(iter(fleet_window_batches(
            [WavStream(p) for p in wavs], num_samples=cfg.num_samples, hop_samples=hop, batch_size=TIMING_B,
            target_sr=cfg.sr, layout=ssess._layout, prefetch=False)))[0]
        extract_ms = (time.perf_counter() - t0) * 1e3
        decide = lambda Z: radial_decide(Z, *on("cuda", cents, thr, priority_ranks(species)))  # noqa: E731
        dev_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                decide(ssess._dispatch(batch1))[0].cpu()
            dev_ms.append((time.perf_counter() - t0) * 1e3)
        times["scan windows/s"] = stats["n_windows"] / stats["wall_seconds"]
        times["scan realtime x"] = stats["realtime_x"]
        times["scan extract ms/batch"] = extract_ms
        times["scan device ms/batch"] = min(dev_ms)
        log(f"[times] fleet scan, balanced tier, B={TIMING_B}, fused RMS, pre-padded rows: {stats['n_windows']} "
            f"windows of {stats['n_files']} recordings ({stats['total_audio_seconds'] / 3600:.3f} h) in "
            f"{stats['wall_seconds']:.3f} s = {times['scan windows/s']:.1f} windows/s, "
            f"{stats['realtime_x']:.1f}x realtime; one batch: extract {extract_ms:.2f} ms (one thread, WavStream "
            f"reads into a new array), copy + transfer + forward + decide + fetch {min(dev_ms):.2f} ms; {smi}")
        del ssess, sess
        torch.cuda.empty_cache()
    return {"launches": launches, "times": times}


def phase_study_times(rng) -> dict:
    """-> {kernel: times} of the split kernel, at the shapes of rows 1 and 2."""
    return {
        "mel_power_ct_fused": time_kernel("mel_power_ct_fused", "DEFAULT_MEL", TIMING_B, rng, exact=True,
                                          algorithm="ct", fast=False, pre_padded=True, iters=5, fused=True),
        "mel_power_ct_fused_bf16": time_kernel("mel_power_ct_fused_bf16", "DEFAULT_MEL", TIMING_B, rng, exact=False,
                                               algorithm="ct", fast=True, pre_padded=False, iters=5, fused=True),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print torch.profiler's kernel table for one B=1024 forward of each tier")
    ap.add_argument("--dense-checkpoints", nargs="?", const="", default=None, metavar="WHICH",
                    help="diagnostic: also time the dense kernel after every phase, with its tables uploaded "
                         "again at other addresses, and at hops whose window row stride gives 2-, 4- and 8-way "
                         "ldmatrix bank conflicts; prints [dense-checkpoint] and [dense-strides] lines. WHICH "
                         "keeps only the checkpoints whose name holds it (each one moves the allocator for the next)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(1)
    # the port and its kernel sources must sit beside this script
    here = Path(__file__).resolve().parent
    missing = [src for src, _ in KERNELS.values() if not (here / src).is_file()]
    if missing:
        print(f"chip_smoke: no anuraxla_torch checkout beside {here} (missing {missing[0]})", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(here))

    torch.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()
    def checkpoint(where: str, **kw) -> None:
        if args.dense_checkpoints is not None and args.dense_checkpoints in where:
            dense_checkpoint(where, **kw)

    phase_build()
    checkpoint("after the build")
    errors = phase_kernel_vs_plain(CASES, rng)
    checkpoint("after kernel-vs-plain")
    launches = phase_main_paths(args.seed, rng)
    checkpoint("after the main paths")
    times = phase_times(args.seed, rng, args.profile, checkpoint)
    for mb in (0, 2, 6, 10, 22, 50):
        checkpoint(f"tables uploaded again behind {mb} MB held", shift_mb=mb)
    if args.dense_checkpoints is not None:
        dense_strides()
    with tempfile.TemporaryDirectory() as tmp:  # the project both phases share
        fit = phase_fit_path(args.seed, np.random.default_rng([args.seed, 6]), Path(tmp))
        evaluation = phase_eval_path(args.seed, Path(tmp))
    study_rng = np.random.default_rng([args.seed, 3])
    errors.update(phase_kernel_vs_plain(STUDY_CASES, study_rng))
    launches.update(phase_study_path())
    times.update(phase_study_times(study_rng))
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "config": t["config"],
            "launches": launches[name], "max_abs_err": errors[name][0], "max_rel_err": errors[name][1],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "tile": t["tile"],
            **({"launches_fit_path": fit["launches"]} if name == "mel_power_ct" else {}),
            "launches_eval_path": evaluation["launches"][name],
        })
    from anuraxla_torch.probes.common import card_line

    smi = card_line()
    cps = times["chunks_per_s"]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s; chunks/s at B=1024: "
        f"balanced {cps['balanced']:.1f}, fast {cps['fast']:.1f}; encode_paths (balanced): "
        + ", ".join(f"{k} {v:.1f}" for k, v in fit["chunks_per_s"].items())
        + f"; fleet scan {evaluation['times']['scan windows/s']:.1f} windows/s "
        f"({evaluation['times']['scan realtime x']:.1f}x realtime)")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
