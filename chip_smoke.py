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
5. the kernel study, after every serving phase so that those run as they did
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
6. print the kernels line, the card's name and power limit, and last the
   device line.

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
import functools
import io
import json
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


def ct_mma_flops(cfg, B: int, T: int, exact: bool) -> float:
    """Tensor-core flops the Cooley-Tukey kernel's form does: per r the
    128-deep products of a_re (and a_im for a complex r) into x_re and x_im of
    128 bins, then the power against the merged filterbank (mels rounded up to
    8), three passes in the exact mode; its own work, not its bound."""
    R = cfg.n_fft // 128
    fma = 0
    for r in range(R // 2 + 1):
        comps = 1 if r == 0 or 2 * r == R else 2
        fma += comps * 2 * 128 * 128 + 128 * 8 * -(-cfg.n_mels // 8)
    return 2.0 * (3 if exact else 1) * fma * B * T


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
        })
    from anuraxla_torch.probes.common import card_line

    smi = card_line()
    cps = times["chunks_per_s"]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s; chunks/s at B=1024: "
        f"balanced {cps['balanced']:.1f}, fast {cps['fast']:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
