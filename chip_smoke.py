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
   CPU's; the scan's span route (``fleet_span_batches`` into the session's
   int16 ring, ``window_expand`` once a scan batch, never in another step):
   the wrapper at B = 1024 with the session's pre-padded layout bit for bit
   its plain version and the host route's rows, on the scan's batch and on a
   full one; times of the benchmark's encode, the device sweep, each grid
   point, ``window_expand`` (CUDA events, with its bound) and the scan
   (windows/s, x realtime, the span route's extract and device ms a batch);
7. the training path at full width (``DEFAULT_MEL``, default ``VAEConfig`` with
   its native decoder, B = 64) from a project root: ``make-synth-data`` (4
   species x 24 WAVs a split), ``train-vae`` (``--ckpt-dir --save-decoder``, KL
   delay 2 and ramp 4) then ``train-vae --resume``, ``mel_power_ct``'s count
   set to 0 just before and read after (once a batch); the loss, read from
   the lines each run prints (step 0 and the final metrics), finite and
   falling, the restored step the saved one; ``train-vae --serving-tier fast
   --bf16`` for 4 steps (``mel_power_ct_bf16`` once a batch); one f32 train
   step on the card held to the same step on the CPU (same params, eps and
   mel batch, the card's: loss 1e-5, gradients 1e-4 of each tensor's max,
   all but 1 % of the parameters within 1e-5 + 1e-4|p|), and the same step
   with TF32 in the backward, which must fail the gradient gate; 3 steps,
   save, restore, 3 more against 6 uninterrupted, bitwise under
   deterministic cuDNN; the trained artifact served (``load_or_init_encoder``
   with no fallback warning, ``EncoderSession`` balanced: 1e-2 of the
   trained module's bf16 encoder, cosine >= 0.99 to its f32 one), fitted
   (``fit-radial``) and evaluated (``evaluate-wav`` on 8 val WAVs, exit codes
   equal to the fit's decisions); times of the train step (f32 and bf16
   trunk: forward + backward and AdamW under events, host-bound; the whole
   step enqueued behind a sleep kernel, the device's own time; examples/s of
   each) and of the mel stream a batch (decode, transfer, ``mel_power_ct``,
   epilogue);
8. int8 serving and checkpoint ingest at full width (``DEFAULT_MEL``, default
   ``VAEConfig``): both kernels of ``csrc/int8_gemm.cu`` (``int8_conv``,
   ``int8_dense``) held to their plain versions bit for bit at every int8
   layer of the encoder (stride family with XLA SAME and TORCH pads, avgpool
   family, the dense at K = 12288 split over the SMs) at B = 1024, 1 and 63,
   in both operand modes (f32 x quantized on load, int8 codes), f32 output
   and raw int32 sums, both forms of the wgmma path where a conv takes both,
   on random x with clamped codes and on x of exact rounding ties, and the
   library route's limits (patches + ``torch._int_mm``) shown on the card; the main
   path ``EncoderSession(quantize=True)`` in the parity tier,
   ``encode_paths`` + ``detect_species`` on the six serving WAVs, counts set
   to 0 just before and read just after (``mel_power_ct``, ``int8_conv``,
   ``int8_dense`` must move), held to the same session on the CPU (row max
   rel <= 0.1, cosine >= 0.997: the free-running bound of
   tests/test_torch_quant.py), to the f32 session (cosine > 0.97, rel L2 <
   0.25) and to the CPU's decisions, and bit for bit to the same session
   with torch's quantization before the int8-operand mode; ``evaluate-wav --serving-tier parity
   --quantize-serving`` exit codes, the balanced tier with int8 refused,
   batch-mate independence (1e-5); ``ingest-encoder --verify`` on the card
   for full-width torch checkpoints with Hydra YAML (stride + GroupNorm,
   avgpool), ``ingest-decoder --verify`` on a pickled full-width decoder, the
   artifacts served against their torch modules (rtol 5e-4 / atol 2e-5) and
   the avgpool one int8 (cosine > 0.97); times at B = 1024 of each int8 layer
   in both operand modes (kernel, plain, each mode's bound, PR 10's kernel,
   torch's quantization + the kernel, the library route, f32 / bf16 cuDNN;
   the int8 mode must not be slower than PR 10's), the encoder a batch
   (int8 quantized on load and with torch's quantization, f32, bf16 trunks),
   the CUDA kernels of one int8 forward (at least 36 fewer than with torch's
   quantization) and ``encode_array`` (int8, parity, balanced);
9. the parallel path (``anuraxla_torch.parallel``) at full width on the one
   card, whose in-process mesh repeats ``cuda:0`` as 4 data shards:
   ``EncoderSession(data_parallel=True)`` over the one card bitwise the single
   session on the six serving WAVs; over 4 shards at B = 1024 on the fit
   phase's 4096 paths, the parity tier held to the single session (rtol 5e-4 /
   atol 2e-5, decisions identical, ``mel_power_ct`` launched 4x as often), the
   balanced tier by cosine (>= 0.999), both timed; ``fit_radial_sharded`` and
   ``fit_map_sharded`` (LDA full; QDA diag, shrink 0.1; tau q 0.05) on the fit
   phase's latents against the single-device fits on the card (the fit
   phase's gates), ``sharded_quantile`` on a [4, 2^20] pool within 1 ulp of
   ``masked_quantile``, each timed against its single-device version; an NCCL
   group of world size 1 (``initialize_multihost``: ``psum`` through it, every
   path kept); one f32 step of ``make_sharded_train_step`` at B = 64 over 2
   data x 2 model shards (the encoder's dense and heads split) against the
   unsharded step with the same noise (loss rtol 1e-4, gradients 1e-4 of each
   tensor's max, parameters rtol 2e-3 / atol 2e-4), and ``train-vae
   --data-parallel`` for 4 steps equal to the run without the flag;
   ``fit-radial --data-parallel --allow-init-encoder`` and ``run-qout-grid
   --device-sweep --data-parallel`` over the 4 shards against the same without
   the flag;
10. the pipeline driver (``anuraxla_torch/scripts/``) at full width in a
   project of its own, as the Makefile's ``e2e-demo`` recipe runs the
   reference's: ``make-synth-data --per-species 48`` (4 species x 48 WAVs a
   split), ``bash -x run_full_pipeline.sh`` with ``TRAIN_STEPS=50`` (normalize,
   train-vae at B = 64, fit-map --preset small-n, encode-wav --jsonl on three
   splits, run-qout-grid over 4 q_out points with --analyze, both folder
   benchmarks), each step timed by the line its start traces. Every artifact
   the reference's driver documents must be there, the species-tree caches
   must name the card's arithmetic, the JSONL's val and test latents equal
   ``encode_paths`` in this process (rtol 5e-4 / atol 2e-5; bitwise
   reported), benchmark-folder's decisions ``radial_decide`` on the CPU from
   them; benchmark-folder again in process with the counts from 0
   (``mel_power_ct`` only). Then ``drive_fast_tier.sh`` in that project
   (``decision_diff``'s line parsed); ``drive_5db_floor.sh`` would add as
   much again: ``perf_logs/pr12/scripts/phase10.py`` runs the phase with both
   drives (``noise_distance``'s table parsed too);
11. the kernel study, after every serving phase so that those run as they did
   before it existed: hold the split-bf16 tensor-core kernel
   (``fused_dots=True``: a TMA ring, wgmma) to its plain version, exact and
   bf16, at ``DEFAULT_MEL`` pre-padded, at the fast tier's frame range, at hop
   320, at R = 2 and at an odd B = 63, to the plain version with f64
   sums, and the exact mode to the plain f32 version; hold each ablated instantiation of the Cooley-Tukey
   kernel to its ablated plain version (six classes and their floor in the
   exact mode, four and theirs in the bf16 mode); drive the study path at full width
   (B = 1024, 626 frames), counts set to 0 just before: the variants sweep
   (hop 384 and hop 320), the pre-padded variants, the ablation probe (exact
   and bf16), the stage split and the three-leg bench, through the ``main`` of
   each module of ``anuraxla_torch.probes`` and of ``anuraxla_torch.bench``
   (the split kernel's counts must move there); time the split kernel, with
   the L2 bytes of its table stream;
12. print the kernels line (``mel_power_ct``'s also with its launches on the
   fit path, the parallel path, the pipeline path, it and
   ``mel_power_ct_bf16`` on the training path; every kernel's on the
   evaluation path; ``window_expand``'s launches are the evaluation path's),
   the card's name and power limit, and last the device line.

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
# the fleet scan's window expansion (source spans -> rows), held and timed on the evaluation path
WINDOW_EXPAND = ("anuraxla_torch/csrc/window_expand.cu",
                 "none: the JAX package cuts windows on the host (anuraxla/pipeline/stream.py fleet_window_batches)")


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
    the mels zero-padded to a 64-row wgmma tile, K1 = 384 (hi, hi, lo
    segments) or 128 in the bf16 mode; its own work, not its bound."""
    R = cfg.n_fft // 128
    K1 = 384 if exact else 128
    mel_rows = 64 * -(-cfg.n_mels // 64)
    fma = 0
    for r in range(R // 2 + 1):
        real = r == 0 or 2 * r == R
        fma += (1 if real else 2) * K1 * 256 + K1 * mel_rows
    return 2.0 * fma * B * T


def ct_split_l2_bytes(cfg, B: int, T: int, exact: bool) -> tuple:
    """(bytes a batch, the first version's): the table bytes the split
    kernel streams from L2, reckoned from its code. Every block (32 frames of
    one row) reads the whole stream once (``ct_fused_tables``); the first
    version of the kernel read its fragment tables, the cat tables' three row blocks
    a r, once for every block of 32 frames."""
    from anuraxla_torch.ops import mel_kernel as mk

    blocks = -(-T // mk.FUSED_TF) * B
    stream = mk.ct_fused_n_stages(cfg.n_fft, cfg.n_mels, exact) * 2 * mk.fused_stage_values(exact)
    _, rhs_real, rhs_cplx, fbcat = mk.ct_tables_folded_cat(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax, exact)
    first = 2 * (rhs_real.numel() + rhs_cplx.numel() + fbcat.shape[0] * 8 * -(-cfg.n_mels // 8))
    return stream * blocks, first * blocks


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
    # an odd number of rows
    Case("mel_power_ct_fused", "DEFAULT_MEL", 63, True, fast=True, fused=True),
    Case("mel_power_ct_fused_bf16", "DEFAULT_MEL", 63, False, fused=True),
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
        tf, stages = mk.ct_fused_tile(cfg.n_fft, cfg.hop_length, exact)
        own = ct_split_flops(cfg, B, T, exact)
        l2, l2_first = ct_split_l2_bytes(cfg, B, T, exact)
        tile = (f"{tf} frames a block, cluster size 1 (no multicast), {stages} ring stages of "
                f"{mk.fused_stage_values(exact) // 512} KB; table stream "
                f"{l2 / 1e9:.1f} GB a batch from L2 (the first version's {l2_first / 1e9:.1f} GB)")
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
    tables = mk._tables(cfg, x.device, "ct_fused" if fused else "dense_frag" if algorithm == "dense" else "ct_split_frag",
                        exact)
    plain_txt = f"{plain_ms:.3f} ms" if plain else "not timed"
    log(f"[times] {kernel} {label} B={B} frames {first}..{first + T - 1}: kernel {ms:.3f} ms, "
        f"plain {plain_txt}, library(torch.stft) {library_ms:.3f} ms (kernel/library {ms / library_ms:.2f}x), "
        f"bound {bound_ms:.3f} ms by {bound_by} (function's least work: {flops / 1e9:.2f} GFLOP "
        f"{'x 3 passes ' if passes == 3 else ''}-> {t_ops:.3f} ms at the bf16 peak, {nbytes / 1e9:.3f} GB -> "
        f"{t_bytes:.3f} ms) = {100 * bound_ms / ms:.2f}% of bound; the kernel's own form does {own / 1e12:.3f} "
        f"TFLOP = {own / ms / 1e9:.2f} TFLOP/s on bf16 {'wgmma' if fused else 'mma.sync'}; tile {tile}; "
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
        ring.send(ring.slot_of(slot))
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
    out.update(Z=qda["Z"], mask=qda["mask"], species=qda["species"])

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
    pre-normalized; both cut their windows on the card, ``window_expand``
    once a batch). Each result is held to the
    same computation on the CPU from the card's latents; the span route's
    rows to the host route's. -> {"launches":
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
    from anuraxla_torch.ops.window_expand import window_expand, window_expand_plain
    from anuraxla_torch.pipeline.benchmark import run_folder_benchmark
    from anuraxla_torch.pipeline.fit import encode_augmented_tree
    from anuraxla_torch.pipeline.session import (
        EncoderSession, concat_species_latents, encode_species_tree, pad_species_latents,
    )
    from anuraxla_torch.pipeline.stream import fleet_span_batches, fleet_window_batches, scan_soundscapes
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
    launches = dict.fromkeys([*KERNELS, "window_expand"], 0)
    times = {}
    scan_batches = -(-SCAN_FILES * int(SCAN_SECONDS / SCAN_HOP_S) // TIMING_B)  # a scan's batches

    def step(name: str, main, argv: list) -> str:
        """One CLI run, launch counts set to 0 just before and read just
        after; -> its standard output (also logged). A scan launches
        ``window_expand`` once a batch, every other step never."""
        buf = io.StringIO()
        reset_launches()
        window_expand.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {**mel_power.launches, "window_expand": window_expand.launches}
        for line in buf.getvalue().splitlines():
            if line.startswith(("✅", "⏱️", "🎯", "💾 on-device", "⚠️", "GLOBAL", "- ")) or "windows" in line:
                log(f"[eval-path]   {line.replace(str(root), '<project>')}")
        log(f"[eval-path] {name}: {dt:.2f} s; launches {counts}")
        if counts["mel_power_ct"] <= 0:
            raise AssertionError(f"eval path, {name}: mel_power_ct was not launched")
        if any(counts[k] for k in FUSED):
            raise AssertionError(f"eval path, {name}: a serving path launched the study's split kernel: {counts}")
        if counts["window_expand"] != (scan_batches if name.startswith("scan-soundscape") else 0):
            raise AssertionError(f"eval path, {name}: window_expand launched {counts['window_expand']} times, "
                                 f"not once a scan batch ({scan_batches})")
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

        # the span route at the main path's shape (B 1024, the session's pre-padded layout): the scan's
        # batch as source spans in the session's pinned int16 ring, expanded on the card by the wrapper,
        # bit for bit its plain version and the host route's rows above (n_valid < B: zero rows past it)
        row_len, col = ssess._layout
        spans1, stags, snv = next(iter(fleet_span_batches(
            [WavStream(p) for p in wavs], num_samples=cfg.num_samples, hop_samples=hop, batch_size=TIMING_B,
            ring=ssess.span_ring())))
        slot = spans1.ring.send(spans1.k, 0, spans1.n)
        window_expand.launches = 0
        got = window_expand(slot, TIMING_B, cfg.num_samples, row_len, col)
        want = window_expand_plain(slot, TIMING_B, cfg.num_samples, row_len, col)
        host = torch.from_numpy(batch).cuda()
        same = (torch.equal(got, want) and torch.equal(got, host) and np.array_equal(stags, tags)
                and snv == n_valid and window_expand.launches == 1)
        # and a full batch (1024 windows of one source at the scan's hop), as the scan cell's batches are
        L = cfg.num_samples
        runs = torch.from_numpy(np.random.default_rng([seed, 8]).integers(
            -32768, 32768, (TIMING_B - 1) * hop + L, dtype=np.int16))
        runs[:2] = torch.tensor([-32768, 32767], dtype=torch.int16)
        table = np.stack([np.arange(TIMING_B) * hop, np.full(TIMING_B, L)], 1).astype(np.int32)
        full = torch.cat([torch.from_numpy(table.view(np.int16).ravel()), runs]).cuda()
        got_full = window_expand(full, TIMING_B, L, row_len, col)
        want_full = window_expand_plain(full, TIMING_B, L, row_len, col)
        same_full = torch.equal(got_full, want_full) and torch.equal(
            got_full[1, col : col + L].cpu(), runs[hop : hop + L].float() / 32768)
        log(f"[eval-path] window_expand at B={TIMING_B} x {row_len} (pre-padded, signal at {col}): the scan's batch "
            f"({snv} windows) bitwise its plain version, the host route's rows, tags and n_valid {same}; a full batch "
            f"bitwise its plain version {same_full}")
        if not (same and same_full and not got[snv:].any() and not got[:, :col].any()):
            raise AssertionError("window_expand differs from its plain version or the host route's rows")
        del got, want, host, got_full, want_full

        def event_ms(fn, reps: int) -> float:
            fn()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b) / reps

        we_ms = event_ms(lambda: window_expand(full, TIMING_B, L, row_len, col), 50)
        we_plain_ms = event_ms(lambda: window_expand_plain(full, TIMING_B, L, row_len, col), 3)
        we_bytes = TIMING_B * row_len * 4 + full.numel() * 2  # rows written once, table and runs read once
        we_bound = we_bytes / PEAK_BYTES_PER_S * 1e3
        times["window_expand"] = {
            "config": f"DEFAULT_MEL B={TIMING_B} x {row_len} pre-padded (signal at {col}), 5 s windows at a "
                      f"{SCAN_HOP_S} s hop", "ms": we_ms, "plain_ms": we_plain_ms, "bound_ms": we_bound}
        log(f"[times] window_expand, B={TIMING_B} x {row_len} pre-padded, 5 s windows at a {SCAN_HOP_S} s hop: "
            f"{we_ms:.4f} ms (CUDA events, 50 launches), plain {we_plain_ms:.3f} ms; bound {we_bound:.4f} ms by bytes "
            f"({we_bytes / 1e9:.4f} GB: rows written once, runs read once) = {100 * we_bound / we_ms:.2f}% of bound; "
            f"{smi}")
        del full

        # the scan timed on a warm session (span route: window_expand once a batch), and its parts
        for _ in range(2):  # the first run warms the page cache and the allocator
            torch.cuda.synchronize()
            window_expand.launches = 0
            _, stats = scan_soundscapes(wavs, ssess, detector="radial", config=cfg1, hop_seconds=SCAN_HOP_S,
                                        log=lambda *a: None)
            if stats["windows_on_device"] != stats["n_windows"] or window_expand.launches != scan_batches:
                raise AssertionError(f"the warm scan took the host route: {stats}, window_expand launched "
                                     f"{window_expand.launches} times for {scan_batches} batches")
            launches["window_expand"] += window_expand.launches
        t0 = time.perf_counter()
        spans1 = next(iter(fleet_span_batches(
            [WavStream(p) for p in wavs], num_samples=cfg.num_samples, hop_samples=hop, batch_size=TIMING_B,
            ring=ssess.span_ring())))[0]
        extract_ms = (time.perf_counter() - t0) * 1e3
        decide = lambda Z: radial_decide(Z, *on("cuda", cents, thr, priority_ranks(species)))  # noqa: E731
        dev_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                decide(ssess._dispatch(spans1))[0].cpu()
            dev_ms.append((time.perf_counter() - t0) * 1e3)
        times["scan windows/s"] = stats["n_windows"] / stats["wall_seconds"]
        times["scan realtime x"] = stats["realtime_x"]
        times["scan extract ms/batch"] = extract_ms
        times["scan device ms/batch"] = min(dev_ms)
        log(f"[times] fleet scan, balanced tier, B={TIMING_B}, fused RMS, pre-padded rows: {stats['n_windows']} "
            f"windows of {stats['n_files']} recordings ({stats['total_audio_seconds'] / 3600:.3f} h) in "
            f"{stats['wall_seconds']:.3f} s = {times['scan windows/s']:.1f} windows/s, "
            f"{stats['realtime_x']:.1f}x realtime, all cut on the card; one batch: extract {extract_ms:.2f} ms (one "
            f"thread, source spans copied into the pinned int16 slot), transfer + window_expand + forward + decide + "
            f"fetch {min(dev_ms):.2f} ms; {smi}")
        del ssess, sess
        torch.cuda.empty_cache()
    return {"launches": launches, "times": times}


TRAIN_FILES = 24  # WAVs of each species and split in the training phase's tree (make-synth-data)
TRAIN_B = 64
TRAIN_STEPS, RESUME_STEPS = 48, 24  # the first train-vae run, then the resumed one
FAST_STEPS = 4  # a train-vae run on the fast tier's features with a bf16 trunk
TRAIN_CMP_B = 16  # rows of the card-vs-CPU step (the CPU side runs the full width too)
TIME_STEPS = 10  # train steps timed, each on its own, after 3 of warm-up
# a sleep kernel before each held step, long against the ~10-20 ms the host
# takes to enqueue one (about 75-90 ms at the H100's 1.7-2 GHz)
HOLD_CYCLES = 150_000_000
# the CLI runs' peak lr: their 72 steps sit in the first third of the 200-step lr warmup, where the
# default 3e-4 would move the loss too little for the check that it falls
TRAIN_LR = 3e-3
# card vs CPU, one f32 step from the same params, mel batch and eps: both sum
# in f32 in other orders, and cuDNN may pick Winograd for a 3x3 conv. The first
# Adam step moves each element by lr times the sign of its gradient, so an
# element whose gradient sits at rounding level may step either way: all but 1 %
# of the parameters within TRAIN_PARAM_ATOL + TRAIN_PARAM_RTOL of their value
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4  # of each tensor's largest gradient, as tests/test_torch_cuda.py holds it
TRAIN_PARAM_ATOL, TRAIN_PARAM_RTOL = 1e-5, 1e-4
TRAIN_BF16_TOL = 1e-2  # the served bf16 trunk against the trained module's, in bf16 too
TRAIN_COS = 0.99  # the served bf16 trunk against the trained module's f32 encoder


def phase_train_path(seed: int, root: Path) -> dict:
    """The training path at full width (``DEFAULT_MEL``, default ``VAEConfig``
    with its native decoder, B = 64) through the ``main`` of each CLI from a
    project root: ``make-synth-data`` (4 species x 24 WAVs a split), then
    ``train-vae`` with ``--ckpt-dir --save-decoder`` and a short KL delay and
    ramp, then ``train-vae --resume``; ``mel_power_ct``'s count set to 0 just
    before the first and read after the second. The loss, read from the lines
    each run prints (step 0 and the final metrics), must be finite and fall,
    the restored step equal the saved one. Then a few steps of
    ``train-vae --serving-tier fast --bf16`` (``mel_power_ct_bf16`` once a
    batch, counted on its own). Then, at the train-step
    level: one f32 step on the card against the same step on the CPU (same
    params, mel batch and eps), and the same step with TF32 on in the backward,
    which the gradient gate must refuse; and k steps, save, restore, k more
    against 2k
    uninterrupted (cuDNN deterministic: bitwise). The trained artifact is
    served (``load_or_init_encoder`` with no fallback warning,
    ``EncoderSession`` in the balanced tier), fitted (``fit-radial``) and
    evaluated (``evaluate-wav``, exit codes held to the fit's decisions).
    Last, times: the train step at B = 64 in f32 and with a bf16 trunk
    (forward + backward and optimizer under events, which the host's launches
    bound; then the whole step enqueued behind a sleep kernel, so that it runs
    back to back: the device's own time), the mel stream a batch (decode,
    transfer, ``mel_power_ct``, epilogue). -> {"launches": {kernel: launches
    on the path}, "times": {...}}."""
    import argparse as ap
    import ast
    import logging

    from anuraxla_torch.cli import evaluate_wav, fit_radial, make_synth_data, train_vae
    from anuraxla_torch.cli.common import session_kwargs
    from anuraxla_torch.config import load_config, priority_ranks, read_radial
    from anuraxla_torch.constants import DEFAULT_ENCODER_DIR
    from anuraxla_torch.constants import DEFAULT_MEL as cfg
    from anuraxla_torch.detect.radial import radial_decide
    from anuraxla_torch.models import checkpoint as ckpt
    from anuraxla_torch.models.train import TrainConfig, create_train_state, make_train_step, vae_loss
    from anuraxla_torch.models.vae import ConvVAE, ConvVAEEncoder, VAEConfig, encoder_params_from_vae
    from anuraxla_torch.ops.frontend import log_mel_batch, mel_to_encoder_input
    from anuraxla_torch.ops.mel_kernel import mel_power, reset_launches
    from anuraxla_torch.pipeline.dataset import load_wav_batch, scan_species_tree
    from anuraxla_torch.pipeline.session import EncoderSession
    from anuraxla_torch.probes.common import card_line
    from anuraxla_torch.utils.precision import exact_f32

    smi = card_line()
    times = {}

    def run(name: str, main, argv: list) -> str:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            main(argv)
        torch.cuda.synchronize()
        log(f"[train-path] {name}: {time.perf_counter() - t0:.2f} s")
        return buf.getvalue()

    (root / "models").mkdir(parents=True)
    with contextlib.chdir(root):  # the project root: train-vae's default artifact lands under models/
        run("make-synth-data", make_synth_data.main, ["--root", ".", "--per-species", str(TRAIN_FILES),
                                                      "--seed", str(seed)])
        train = ["--root", "train_chunks", "--batch-size", str(TRAIN_B), "--io-threads", "8", "--lr",
                 str(TRAIN_LR), "--kl-delay", "2", "--kl-warmup", "4", "--seed", str(seed)]
        reset_launches()  # count only the training path from here
        out1 = run("train-vae", train_vae.main, [*train, "--ckpt-dir", "ckpt", "--steps", str(TRAIN_STEPS),
                                                 "--save-decoder"])
        saved = ckpt.latest_step(root / "ckpt")
        out2 = run("train-vae --resume", train_vae.main, [*train, "--ckpt-dir", "ckpt", "--steps", str(RESUME_STEPS),
                                                          "--resume"])
        launches = dict(mel_power.launches)
        # the fast tier's features (crop-first, the kernel's bf16 mode) and a
        # bf16 trunk, a few steps into an artifact of their own
        reset_launches()
        out3 = run("train-vae --serving-tier fast --bf16", train_vae.main,
                   [*train, "--steps", str(FAST_STEPS), "--serving-tier", "fast", "--bf16", "--out", "fast"])
        fast = dict(mel_power.launches)
    for line in (out1 + out2).splitlines():
        log(f"[train-path]   {line.replace(str(root), '<project>')}")

    def first_and_final(out: str) -> tuple:
        """-> (step 0's metrics, the final metrics) from the lines a run
        prints: the loop logs every 50 steps, as the reference's."""
        m = re.search(r"^step 0: loss=(\S+) recon=(\S+) kl=(\S+)$", out, re.M)
        return dict(zip(("loss", "recon", "kl"), map(float, m.groups()))), ast.literal_eval(
            re.search(r"final (\{.*\})$", out, re.M).group(1))

    (m0, m47), (m48, m71) = first_and_final(out1), first_and_final(out2)
    resumed = re.search(r"resumed from step (\d+)", out2)
    log(f"[train-path] loss at steps 0, {TRAIN_STEPS - 1}, {TRAIN_STEPS}, {TRAIN_STEPS + RESUME_STEPS - 1}: "
        f"{m0['loss']:.4f}, {m47['loss']:.4f}, {m48['loss']:.4f}, {m71['loss']:.4f}; recon {m0['recon']:.4f} -> "
        f"{m71['recon']:.4f}; mel_power_ct launched {launches['mel_power_ct']} times; checkpoint step {saved}, "
        f"restored {resumed and resumed.group(1)}")
    if not all(np.isfinite(list(m.values())).all() for m in (m0, m47, m48, m71)):
        raise AssertionError(f"training path: a loss is not finite: {m0}, {m47}, {m48}, {m71}")
    # β is full from step 5: steps 48 and 71 weigh the same objective
    if not (m71["loss"] < m48["loss"] and m71["recon"] < m0["recon"]):
        raise AssertionError(f"training path: the loss did not fall (steps {TRAIN_STEPS} -> "
                             f"{TRAIN_STEPS + RESUME_STEPS - 1}: {m48['loss']:.4f} -> {m71['loss']:.4f}; recon from "
                             f"step 0: {m0['recon']:.4f} -> {m71['recon']:.4f})")
    if not (saved == TRAIN_STEPS and resumed and int(resumed.group(1)) == saved
            and ckpt.latest_step(root / "ckpt") == TRAIN_STEPS + RESUME_STEPS):
        raise AssertionError(f"training path: checkpoint step {saved}, restored {resumed}")
    f0, f3 = first_and_final(out3)
    log(f"[train-path] fast tier, bf16 trunk: loss at steps 0 and {FAST_STEPS - 1} {f0['loss']:.4f}, "
        f"{f3['loss']:.4f}; launches { {k: v for k, v in fast.items() if v} }; artifact "
        f"{ckpt.load_encoder(root / 'fast')[1].dtype}")
    if launches["mel_power_ct"] != TRAIN_STEPS + RESUME_STEPS or any(
            v for k, v in launches.items() if k != "mel_power_ct"):
        raise AssertionError(f"training path: launches {launches}, not mel_power_ct once a batch")
    if fast["mel_power_ct_bf16"] != FAST_STEPS or any(v for k, v in fast.items() if k != "mel_power_ct_bf16") \
            or not (np.isfinite(list(f0.values())).all() and np.isfinite(list(f3.values())).all()):
        raise AssertionError(f"fast-tier training: launches {fast}, losses {f0}, {f3}")

    # one batch's mel on the card (the kernel, held to its plain version above)
    files = sorted(p for wavs in scan_species_tree(root / "train_chunks").values() for p in wavs)
    audio = load_wav_batch(files[:TRAIN_B], sr=cfg.sr, num_samples=cfg.num_samples, num_threads=8).audio
    mel_card = mel_to_encoder_input(log_mel_batch(torch.from_numpy(audio).cuda(), cfg))

    # one f32 step on each side from the same params, mel batch and eps
    vcfg = VAEConfig()
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10, beta=0.25, kl_delay_steps=0,
                     kl_warmup_steps=0, seed=seed)
    eps = torch.from_numpy(np.random.default_rng([seed, 9]).standard_normal((TRAIN_CMP_B, 128)).astype(np.float32))
    batch = mel_card[:TRAIN_CMP_B].cpu()
    step = make_train_step(tc.beta, seed=seed)
    res = {}
    for dev in ("cuda", "cpu"):
        _, st = create_train_state(vcfg, tc, device=dev)
        t0 = time.perf_counter()
        st, m = step(st, batch.to(dev), eps.to(dev))
        res[dev] = ({k: float(v) for k, v in m.items()}, {k: p.grad.cpu() for k, p in st.model.named_parameters()},
                    {k: v.cpu() for k, v in st.model.state_dict().items()}, time.perf_counter() - t0)
    (mc, gc, pc, _), (mp, gp, pp, cpu_s) = res["cuda"], res["cpu"]

    def grad_err(g: dict) -> float:
        return max(float((g[k] - gp[k]).abs().max() / gp[k].abs().max().clamp_min(1e-30)) for k in gp)

    loss_err = max(abs(mc[k] / mp[k] - 1) for k in mc)
    d = torch.cat([(pc[k] - pp[k]).abs().ravel() for k in pp])
    scale = torch.cat([pp[k].abs().ravel() for k in pp])
    off = float((d > TRAIN_PARAM_ATOL + TRAIN_PARAM_RTOL * scale).float().mean())
    # the same step on the card with TF32 on in the backward alone (the forward
    # holds it off itself): the fault the gradient gate is there to see
    _, st = create_train_state(vcfg, tc)
    with exact_f32():
        loss, _ = vae_loss(st.model, batch.cuda(), eps.cuda(), tc.beta)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=True):
            loss.backward()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    tf32_err = grad_err({k: p.grad.cpu() for k, p in st.model.named_parameters()})
    log(f"[train-path] one f32 step at B={TRAIN_CMP_B} on the card's mel, card vs CPU ({cpu_s:.2f} s): loss "
        f"{mc['loss']:.6f} / {mp['loss']:.6f}, worst relative of loss/recon/kl {loss_err:.3e} (gate "
        f"{TRAIN_LOSS_RTOL}); gradients {grad_err(gc):.3e} of each tensor's max (gate {TRAIN_GRAD_TOL}); "
        f"{off:.2e} of the params beyond {TRAIN_PARAM_ATOL} + {TRAIN_PARAM_RTOL}|p| (gate 0.01), the largest "
        f"|d| {float(d.max()):.3e}; with TF32 in the backward the gradients read {tf32_err:.3e} (must fail the gate)")
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err(gc) <= TRAIN_GRAD_TOL and off <= 0.01):
        raise AssertionError("the card's train step disagrees with the CPU's")
    if tf32_err <= TRAIN_GRAD_TOL:
        raise AssertionError(f"TF32 in the backward passes the gradient gate ({tf32_err:.3e}): the gate cannot "
                             "tell an f32 backward from a TF32 one")

    # k steps, save, restore, k more against 2k uninterrupted (deterministic cuDNN)
    k = 3
    n = TRAIN_B // (2 * k)
    batches = [mel_card[i * n:(i + 1) * n] for i in range(2 * k)]
    tc = dataclasses.replace(tc, kl_delay_steps=1, kl_warmup_steps=2, warmup_steps=1)
    step = make_train_step(tc.beta, tc.kl_warmup_steps, tc.kl_delay_steps, seed=seed)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        _, a = create_train_state(vcfg, tc)
        for b in batches[:k]:
            a, _ = step(a, b)
        ckpt.save_train_state(root / "ckpt2", a)
        _, a = create_train_state(vcfg, tc)
        a = ckpt.restore_train_state(root / "ckpt2", a)
        restored_step = a.step
        for b in batches[k:]:
            a, ma = step(a, b)
        _, u = create_train_state(vcfg, tc)
        for b in batches:
            u, mu = step(u, b)
    sa, su = a.model.state_dict(), u.model.state_dict()
    diff = max(float((sa[n] - su[n]).abs().max()) for n in su)
    log(f"[train-path] {k} steps, save, restore (step {restored_step}), {k} more vs {2 * k} uninterrupted "
        f"(deterministic cuDNN): loss {float(ma['loss']):.6f} / {float(mu['loss']):.6f}, params max |d| {diff:.3e}")
    if restored_step != k or diff != 0.0 or not torch.equal(ma["loss"], mu["loss"]):
        raise AssertionError("a resumed run on the card differs from an uninterrupted one")

    # serve what was trained: the default artifact, no fallback warning
    art = root / DEFAULT_ENCODER_DIR
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    logging.getLogger("anuraxla_torch.models.checkpoint").addHandler(handler)
    try:
        params, ecfg = ckpt.load_or_init_encoder(None, root)
    finally:
        logging.getLogger("anuraxla_torch.models.checkpoint").removeHandler(handler)
    if records:
        raise AssertionError(f"the trained artifact was not found: {records[0].getMessage()}")
    balanced = session_kwargs(ap.Namespace(serving_tier="balanced", batch_size=64, io_threads=8))
    sess = EncoderSession(mel=cfg, project_root=root, **balanced).load()
    served = torch.from_numpy(sess.encode_array(audio))
    model = ConvVAE(ecfg)
    model.load_state_dict(torch.load(root / "ckpt" / str(TRAIN_STEPS + RESUME_STEPS) / ckpt.TRAIN_STATE_FILE,
                                     weights_only=True)["model"])
    enc_state = encoder_params_from_vae(model.state_dict())
    if any(not torch.equal(enc_state[n], params[n]) for n in params):
        raise AssertionError("the encoder artifact is not the trained module's encoder")
    mus = {}
    for dtype in ("bfloat16", "float32"):
        enc = ConvVAEEncoder(dataclasses.replace(ecfg, dtype=dtype)).cuda().eval()
        enc.load_state_dict(enc_state)
        with torch.inference_mode():
            mus[dtype] = enc(mel_card)["mu"].cpu()
    bf_err = float((served - mus["bfloat16"]).abs().max())
    cos = float(torch.nn.functional.cosine_similarity(served, mus["float32"], dim=1).min())
    log(f"[train-path] served (balanced tier) vs the trained module's encoder on the same mel: bf16 max |d| "
        f"{bf_err:.3e} (gate {TRAIN_BF16_TOL}), cosine to f32 >= {cos:.6f} (gate {TRAIN_COS})")
    if not (bf_err <= TRAIN_BF16_TOL and cos >= TRAIN_COS):
        raise AssertionError("the served artifact disagrees with the trained module")

    tier = ["--config", "config.json", "--encoder", str(art), "--serving-tier", "balanced", "--io-threads", "8"]
    held = [sorted((root / "val_chunks" / sp).glob("*.wav"))[i] for sp in sorted(scan_species_tree(
        root / "val_chunks")) for i in (0, 1)]
    exits = []
    with contextlib.chdir(root):
        run("fit-radial", fit_radial.main, ["--root", "train_chunks", *tier])
        for wav in held:
            try:
                run(f"evaluate-wav {wav.parent.name}/{wav.name}", evaluate_wav.main, ["--wav", str(wav), *tier])
            except SystemExit as e:
                exits.append(e.code)
    species, centroids, thresholds, _ = read_radial(load_config(root / "config.json"))
    one = EncoderSession(mel=cfg, project_root=root, **dict(balanced, batch_size=1)).load()
    Zh, ok, err = one.encode_paths(held)
    if not ok.all():
        raise AssertionError(f"held-out WAVs: {err}")
    det = radial_decide(torch.from_numpy(Zh), torch.from_numpy(centroids), torch.from_numpy(thresholds),
                        torch.from_numpy(priority_ranks(species)))[0]
    want = [0 if d else 2 for d in det.tolist()]
    log(f"[train-path] evaluate-wav exit codes {exits}; the fit's decisions {want}")
    if exits != want:
        raise AssertionError(f"served exit codes {exits} differ from the fit's decisions {want}")

    # times after warm-up: the train step (events around each step's parts,
    # which read the host's launch rate as well; then the whole step enqueued
    # while a sleep kernel holds the card, so it runs without waiting for a
    # launch: the device's own time), then the mel stream a batch
    x = mel_card
    eps = torch.randn(TRAIN_B, 128, device="cuda")

    def spread(v: list) -> str:
        return f"{np.median(v):.3f} ({min(v):.3f}-{max(v):.3f})"

    def one_step(st):
        st.optimizer.zero_grad(set_to_none=True)
        loss, _ = vae_loss(st.model, x, eps, tc.beta)
        loss.backward()

    for dtype in ("float32", "bfloat16"):
        _, st = create_train_state(dataclasses.replace(vcfg, dtype=dtype), tc)
        fb, held = [], []
        with exact_f32():
            for it in range(3 + TIME_STEPS):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
                one_step(st)
                ev[1].record()
                st.optimizer.step()
                ev[2].record()
                if it >= 3:
                    fb.append(ev)
            for it in range(3 + TIME_STEPS):
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                t0 = time.perf_counter()
                ev[0].record()
                torch.cuda._sleep(HOLD_CYCLES)
                ev[1].record()
                one_step(st)
                st.optimizer.step()
                ev[2].record()
                enqueued = (time.perf_counter() - t0) * 1e3
                if it >= 3:
                    held.append((ev, enqueued))
        torch.cuda.synchronize()
        f = [e[0].elapsed_time(e[1]) for e in fb]
        o = [e[1].elapsed_time(e[2]) for e in fb]
        step_ms = [a + b for a, b in zip(f, o)]
        dev = [e[1].elapsed_time(e[2]) for e, _ in held]
        slept = [e[0].elapsed_time(e[1]) for e, _ in held]
        enq = [q for _, q in held]
        # launch-free only if the host had enqueued the step before the sleep ended
        launch_free = max(enq) < min(slept)
        times[f"train step {dtype} ms"] = {
            "forward+backward": float(np.median(f)), "optimizer": float(np.median(o)),
            "step": [float(min(step_ms)), float(np.median(step_ms)), float(max(step_ms))],
            "examples/s": TRAIN_B / float(np.median(step_ms)) * 1e3,
            "device step": [float(min(dev)), float(np.median(dev)), float(max(dev))],
            "device examples/s": TRAIN_B / float(np.median(dev)) * 1e3, "launch-free": bool(launch_free),
        }
        log(f"[times] train step at B={TRAIN_B}, {dtype} trunk, default VAEConfig, median (min-max) of "
            f"{TIME_STEPS} after 3: events: forward + backward {spread(f)} ms, AdamW {spread(o)} ms, step "
            f"{spread(step_ms)} ms = {TRAIN_B / np.median(step_ms) * 1e3:.1f} examples/s (host-bound); the step "
            f"held behind a {np.median(slept):.1f} ms sleep (enqueued in {spread(enq)} ms, host clock; launch-free: "
            f"{launch_free}): {spread(dev)} ms = {TRAIN_B / np.median(dev) * 1e3:.1f} examples/s (device); {smi}")
    dec, h2d = [], []
    for it in range(6):
        t0 = time.perf_counter()
        rows = load_wav_batch(files[:TRAIN_B], sr=cfg.sr, num_samples=cfg.num_samples, num_threads=8).audio
        dt = time.perf_counter() - t0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        y = torch.from_numpy(rows).cuda()
        ev[1].record()
        torch.cuda.synchronize()
        if it:
            dec.append(dt * 1e3)
            h2d.append(ev[0].elapsed_time(ev[1]))

    def device_ms(fn, n=10) -> float:
        fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(n):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / n

    ker = device_ms(lambda: mel_power(y, cfg, num_frames=cfg.total_frames, first_frame=0, exact=True))
    full = device_ms(lambda: log_mel_batch(y, cfg))
    times["mel stream ms"] = {"decode": float(np.mean(dec)), "transfer": float(np.mean(h2d)),
                              "mel_power_ct": ker, "log_mel_batch": full}
    rate = re.findall(r"\(([\d.]+) examples/s\)", out1 + out2)
    times["train-vae examples/s"] = [float(r) for r in rate]
    log(f"[times] mel stream a batch of {TRAIN_B} (files in the page cache): decode {np.mean(dec):.2f} ms (host "
        f"clock, 8 threads, mean of 5 after 1), transfer {np.mean(h2d):.3f} ms (pageable, mean of 5); "
        f"mel_power_ct {ker:.3f} ms, log_mel_batch {full:.3f} ms (kernel + epilogue; 10 back to back after 1); "
        f"train-vae end to end "
        f"{', '.join(rate)} examples/s (the two runs, decode and start-up included); {smi}")
    return {"launches": {"mel_power_ct": launches["mel_power_ct"], "mel_power_ct_bf16": fast["mel_power_ct_bf16"]},
            "times": times}


PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
QUANT = "anuraxla/models/quant.py"
INT8_KERNELS = {
    "int8_conv": ("anuraxla_torch/csrc/int8_gemm.cu",
                  f"{QUANT}:204 (_int8_conv: lax.conv_general_dilated on int8, int32 sums, its operand from "
                  f"_quant_x :194; XLA, not Pallas)"),
    "int8_dense": ("anuraxla_torch/csrc/int8_gemm.cu",
                   f"{QUANT}:198 (_int8_dot: lax.dot_general on int8, int32 sums, its operand from _quant_x :194; "
                   f"XLA, not Pallas)"),
}
INT8_BATCHES = (TIMING_B, 1, 63)  # rows the kernels are held to their plain versions at
# convs whose Cin % 16 == 0 but no power of two: the gathered form of the wgmma path
INT8_GATHERED = ((48, 16, 48, 64, 1, ((1, 1), (1, 1))), (48, 16, 96, 128, 2, ((0, 1), (0, 1))))
# PR 10's kernel (mma.sync, int8 x) at B = 1024, perf_logs/pr10/full1.log:322-330
PR10_INT8_MS = {"EncoderBlock_0/Conv_0": 0.352, "EncoderBlock_0/Conv_1": 0.519, "EncoderBlock_1/Conv_0": 0.304,
                "EncoderBlock_1/Conv_1": 0.475, "EncoderBlock_2/Conv_0": 0.286, "EncoderBlock_2/Conv_1": 0.481,
                "EncoderBlock_3/Conv_0": 0.264, "EncoderBlock_3/Conv_1": 0.481, "Dense_0": 0.268}
INT8_TIMED_CONV = "EncoderBlock_0/Conv_1"  # the kernels line's int8_conv shape: the conv with the most bytes
# free running, card vs CPU and port vs reference: the bound of
# tests/test_torch_quant.py (FREE_REL, FREE_COS): the integer parts are
# bitwise, but a last-bit difference in the f32 layers between them can flip
# an activation code at a rounding tie, and a flip moves that row's later layers
INT8_FREE_REL, INT8_FREE_COS = 0.1, 0.997
INGEST_RTOL, INGEST_ATOL = 5e-4, 2e-5  # tests/test_quant.py:152, an ingested encoder against its torch module


class FullWidthDecoder(torch.nn.Module):
    """A reference-style decoder at the default VAEConfig's widths, pickled
    whole for ``ingest-decoder --verify``: two linears, a view to [256, 12, 4],
    four ConvTranspose2d(4, 2, 1) + GroupNorm + SiLU, a 3x3 output conv."""

    def __init__(self):
        super().__init__()
        nn = torch.nn
        self.fc1, self.fc2 = nn.Linear(128, 512), nn.Linear(512, 256 * 12 * 4)
        chans = (256, 128, 64, 32, 16)
        self.up = nn.ModuleList()
        for a, b in zip(chans[:-1], chans[1:]):
            self.up.extend([nn.ConvTranspose2d(a, b, 4, stride=2, padding=1), nn.GroupNorm(8, b)])
        self.out = nn.Conv2d(16, 1, 3, padding=1)

    def forward(self, z):
        f = torch.nn.functional
        x = f.silu(self.fc2(f.silu(self.fc1(z)))).view(-1, 256, 12, 4)
        for i in range(0, len(self.up), 2):
            x = f.silu(self.up[i + 1](self.up[i](x)))
        return self.out(x)


def int8_layers(cfg):
    """(name, shape) of each int8 contraction of ``cfg``'s encoder: convs
    (H, W, Cin, Cout, stride, pads), then the dense (K, N)."""
    from anuraxla_torch.models.quant import _block_convs, _conv_pads
    from anuraxla_torch.ops.int8 import conv_out_hw

    (h, w), cin, out = cfg.input_hw, 1, []
    for i, width in enumerate(cfg.widths):
        for j, stride in _block_convs(cfg):
            pads = _conv_pads(cfg, h, w, stride)
            out.append((f"EncoderBlock_{i}/Conv_{j}", (h, w, cin, width, stride, pads)))
            (h, w), cin = conv_out_hw(h, w, stride, pads), width
        if cfg.downsample == "avgpool":
            h, w = h // 2, w // 2
    out.append(("Dense_0", (h * w * cin, cfg.dense_width)))
    return out


def int8_operands(shape, B: int, gen: torch.Generator, ties: bool = False):
    """f32 activations, per-row scales, int8 weights, per-channel scales and
    biases on the card. x / sx reaches past +-127 (clamped codes); with
    ``ties`` every x is (k + 1/2) sx exactly, sx a power of two, k in
    [-140, 140): each code a rounding tie (half to even), some clamped."""
    dev = "cuda"
    if len(shape) == 2:
        (K, N), xs = shape, (B, shape[0])
        w = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
    else:
        H, W, cin, N = shape[:4]
        xs = (B, H, W, cin)
        w = torch.randint(-127, 128, (3, 3, cin, N), generator=gen, device=dev, dtype=torch.int8)
    if ties:
        sx = torch.full((B,), 2.0 ** -5, device=dev)
        x = (torch.randint(-140, 140, xs, generator=gen, device=dev).float() + 0.5) * 2.0 ** -5
    else:
        sx = torch.rand(B, generator=gen, device=dev) * 0.05 + 1e-3
        x = torch.randn(xs, generator=gen, device=dev) * 60.0 * sx.reshape(-1, *[1] * (len(xs) - 1))
    sw = torch.rand(N, generator=gen, device=dev) * 0.01 + 1e-4
    return x, w, sx, sw, torch.randn(N, generator=gen, device=dev)


def int8_codes(ops):
    """The same operands with x as int8 codes (torch's quantization, the
    reference's ``_quant_x``): the int8-operand mode."""
    from anuraxla_torch.ops.int8 import quantize_rows

    return (quantize_rows(ops[0], ops[2]),) + tuple(ops[1:])


@contextlib.contextmanager
def torch_quantization():
    """The int8 forward's second route, for the checks: torch's quantization
    (the reference's ``_quant_x``) before the int8-operand mode of each
    contraction, in place of the kernels' quantization on load."""
    from anuraxla_torch.models import quant as quant_mod
    from anuraxla_torch.ops import int8 as i8

    def conv(x, wq, sx, *args, **kw):
        return i8.int8_conv(i8.quantize_rows(x, sx), wq, sx, *args, **kw)

    def dense(x, wq, sx, *args, **kw):
        return i8.int8_dense(i8.quantize_rows(x, sx), wq, sx, *args, **kw)

    saved = quant_mod.int8_conv, quant_mod.int8_dense
    quant_mod.int8_conv, quant_mod.int8_dense = conv, dense
    try:
        yield
    finally:
        quant_mod.int8_conv, quant_mod.int8_dense = saved


def int8_call(shape, ops, plain: bool = False, raw: bool = False, packed=None):
    from anuraxla_torch.ops import int8 as i8

    if len(shape) == 2:
        if plain:
            return i8.int8_dense_plain(*ops, raw=raw)
        return i8.int8_dense(*ops, raw=raw, packed=packed)
    if plain:
        return i8.int8_conv_plain(*ops, shape[4], shape[5], raw=raw)
    return i8.int8_conv(*ops, shape[4], shape[5], raw=raw, packed=packed)


def int8_tile(shape, B: int) -> str:
    """The kernel's tile for a layer, as the wrapper chooses it."""
    from anuraxla_torch.ops import int8 as i8

    if len(shape) == 2:
        K, N = shape
        bn, bk = i8.wgmma_tile(K, N, dense=True)
        S = -(-K // bk)
        splits = i8.dense_splits(-(-B // 128), N // bn, S, torch.cuda.get_device_properties(0).multi_processor_count)
        return (f"wgmma m64n{bn}k32 s8, 128 x {bn} a block ({N // bn} column tiles), {S} K stages of {bk} in a "
                f"4-slot TMA ring, no swizzle, split-K {splits} (last block adds the partials)")
    H, W, cin, N, stride, pads = shape
    tile = i8.wgmma_tile(9 * cin, N)
    if tile is None:
        if cin == 1:
            return f"first conv: one output pixel a thread, its 9 codes in 3 words, 3 dp4a a channel, {N} channels"
        return f"simple: mma.sync m16n8k32 s8, 64 x {min(N, 64) if N > 32 else 32} a block, K {9 * cin} in steps of 32"
    bn, bk = tile
    form = "halo" if i8.halo_fits(B, H, W, cin, N, stride, pads, bk) else "gathered A"
    return (f"wgmma m64n{bn}k32 s8, 128 x {bn} a block, {-(-9 * cin // bk)} K stages of {bk} in a 4-slot TMA "
            f"ring, no swizzle, {form}")


def int8_library(shape, ops):
    """The library route (never called by the port): im2col patches, then
    ``torch._int_mm``, then the same epilogue; -> (fn, None) or (None, why not)."""
    from anuraxla_torch.ops.int8 import dequantize

    _, w, sx, sw, bias = ops

    def fn():
        a = patches_of(shape, ops)
        acc = torch._int_mm(a.reshape(-1, a.shape[-1]), w.reshape(a.shape[-1], -1))
        return dequantize(acc, sx, sw, bias).reshape(*a.shape[:-1], -1)  # the kernel's output shape

    try:
        fn()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:160]
    return fn, None


def patches_of(shape, ops):
    from anuraxla_torch.ops.int8 import patches

    return ops[0] if len(shape) == 2 else patches(ops[0], shape[4], shape[5])


def exact_n(shape, B: int) -> int:
    """Outputs of the contraction at B rows."""
    from anuraxla_torch.ops.int8 import conv_out_hw

    if len(shape) == 2:
        return B * shape[1]
    ho, wo = conv_out_hw(*shape[:2], shape[4], shape[5])
    return B * ho * wo * shape[3]


def int8_work(shape, B: int, f32: bool = False) -> tuple:
    """(int8 operations, bytes) the function needs: each input read once
    (x — int8 codes, or f32 activations in the quantize-on-load mode —,
    weights, scales, biases), the f32 output written once."""
    if len(shape) == 2:
        (K, N), M = shape, B
        x_el = B * K
    else:
        from anuraxla_torch.ops.int8 import conv_out_hw

        H, W, cin, N, stride, pads = shape
        ho, wo = conv_out_hw(H, W, stride, pads)
        M, K, x_el = B * ho * wo, 9 * cin, B * H * W * cin
    return 2.0 * M * K * N, (4 if f32 else 1) * x_el + K * N + 4 * B + 8 * N + 4 * M * N


def phase_int8_path(seed: int, root: Path) -> dict:
    """Int8 serving and checkpoint ingest at full width (``DEFAULT_MEL``,
    default ``VAEConfig``): both kernels of ``csrc/int8_gemm.cu`` held to
    their plain versions bit for bit at every int8 layer of the encoder
    (stride family with XLA SAME and with TORCH pads, avgpool family, the dense
    at K = 12288 under split-K) at B = 1024, 1 and 63, in both operand modes,
    raw sums too, on clamped codes and on rounding ties; the main path —
    ``EncoderSession(quantize=True)`` in the parity tier, ``encode_paths`` +
    ``detect_species`` on the six serving WAVs, launch counts set to 0 just
    before and read just after (``mel_power_ct``, ``int8_conv`` and
    ``int8_dense`` must move) — against the same session on the CPU (the
    free-running bound), the f32 session (cosine > 0.97, relative L2 < 0.25),
    the CPU's decisions and, bit for bit, the session with torch's
    quantization before the int8-operand mode;
    ``evaluate-wav --serving-tier parity --quantize-serving`` exit codes; the
    balanced tier with int8 refused; batch-mate independence on the card.
    Ingest: full-width torch checkpoints with Hydra YAML (stride + GroupNorm,
    avgpool without norm) through ``ingest-encoder --verify`` on the card,
    a pickled decoder through ``ingest-decoder --verify``; each artifact
    served (``EncoderSession`` against the torch module on the same mel,
    rtol 5e-4 / atol 2e-5; the decoder through ``load_decoder``), the
    avgpool one also int8 (cosine > 0.97). Times at B = 1024: each int8 layer
    in both operand modes (kernel, plain version, bound, PR 10's kernel,
    torch's quantization + the kernel, the library route and the f32 / bf16
    cuDNN conv of the layer), the encoder a batch (int8 both ways, f32 and
    bf16 trunks), the CUDA kernels of one int8 forward, ``encode_array``
    chunks/s (int8, parity, balanced).
    -> {"errors", "launches", "times"}."""
    import argparse as ap
    import dataclasses as dc

    import yaml

    from anuraxla_torch.cli import evaluate_wav, ingest_decoder, ingest_encoder
    from anuraxla_torch.cli.common import session_kwargs
    from anuraxla_torch.cli.evaluate_wav import detect_species
    from anuraxla_torch.constants import DEFAULT_MEL as mel
    from anuraxla_torch.models import hydra_ingest as hi
    from anuraxla_torch.models.checkpoint import load_decoder
    from anuraxla_torch.models.quant import encoder_apply_quantized, quantize_encoder
    from anuraxla_torch.models.vae import ConvVAEEncoder, IngestedDecoder, VAEConfig, init_encoder_params
    from anuraxla_torch.ops import int8 as i8
    from anuraxla_torch.ops.frontend import log_mel_batch
    from anuraxla_torch.ops.mel_kernel import mel_power, reset_launches
    from anuraxla_torch.pipeline.session import EncoderSession, session_fingerprint
    from anuraxla_torch.probes.common import card_line, cuda_ms
    from anuraxla_torch.utils.precision import exact_f32
    from anuraxla_torch.utils.wavio import read_wav

    smi = card_line()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    vcfg = VAEConfig()

    # 1. each kernel against its plain version, bitwise, in both operand
    # modes (f32 x quantized on load; int8 codes); random x with clamped
    # codes, and x of rounding ties only. The encoder's wgmma convs all take
    # the halo form; two convs whose Cin is no power of two take the
    # gathered one
    cases = [("SAME", name, shape) for name, shape in int8_layers(vcfg)]
    same = dict(int8_layers(vcfg))
    cases += [("TORCH", n, s) for n, s in int8_layers(dc.replace(vcfg, conv_padding="TORCH")) if s != same[n]]
    cases += [("avgpool", n, s) for n, s in int8_layers(dc.replace(vcfg, downsample="avgpool"))]
    cases[-1:-1] = [("gathered", f"Cin {s[2]}", s) for s in INT8_GATHERED]
    halo = {i8.halo_fits(TIMING_B, *s[:4], s[4], s[5], i8.stage_depth(9 * s[2])) for _, _, s in cases
            if len(s) == 6 and i8.wgmma_tile(9 * s[2], s[3])}
    if halo != {True, False}:
        raise AssertionError("the int8 gates miss the halo or the gathered form of the wgmma path")
    n_checked, n_ties, n_clamped = 0, 0, 0
    for family, name, shape in cases:
        packed = i8.pack_weight(int8_operands(shape, 1, gen)[1]) if len(shape) == 2 else None
        for B in INT8_BATCHES:
            for ties in (False, True):
                ops = int8_operands(shape, B, gen, ties=ties)
                if packed is not None:  # the dense's packed W, made once for its shape
                    ops = (ops[0], i8.unpack_weight(packed, shape[0]).contiguous(), *ops[2:])
                codes = int8_codes(ops)
                u = ops[0] / ops[2].reshape(-1, *[1] * (ops[0].ndim - 1))
                n_ties += int((u - u.floor() == 0.5).sum())
                n_clamped += int((u.abs() > 127.5).sum())
                for mode, o in (("f32", ops), ("int8", codes)):
                    for raw in (False, True):
                        ref = int8_call(shape, o, plain=True, raw=raw)
                        got = int8_call(shape, o, raw=raw, packed=packed)
                        torch.cuda.synchronize()
                        if not torch.equal(got, ref):
                            d = (got.double() - ref.double()).abs().max().item()
                            raise AssertionError(f"int8 {family} {name} {shape} B={B} ties={ties} {mode} x "
                                                 f"raw={raw}: kernel != plain (max {d})")
                        n_checked += 1
                del ops, codes, u, got, ref
    dense = [(B, i8.dense_splits(-(-B // 128), 2, 96, torch.cuda.get_device_properties(0).multi_processor_count))
             for B in INT8_BATCHES]
    log(f"[int8-path] int8_conv / int8_dense equal their plain versions bit for bit in {n_checked} cases: "
        f"{len(cases)} layer shapes (stride SAME, TORCH pads where they differ, avgpool, two convs of the gathered "
        f"form; the dense at K = "
        f"{cases[-1][2][0]}, split-K over (M, splits) {dense}) x B in {INT8_BATCHES} x (random x, {n_clamped} codes "
        f"clamped; x of ties only, {n_ties} ties in all, half to even) x (f32 x quantized on load, int8 codes) x "
        f"(f32 output, raw int32 sums) "
        f"({time.perf_counter() - t0:.1f} s)")
    errors = {"int8_conv": 0.0, "int8_dense": 0.0}

    # the library route's limits, on the card
    for what, shape, B in (("first conv (K = 9)", cases[0][2], TIMING_B), ("a batch of one", cases[1][2], 1),
                           ("16 rows", cases[1][2], 16)):
        _, why = int8_library(shape, int8_codes(int8_operands(shape, B, gen)))
        log(f"[int8-path] library route (patches + torch._int_mm) on {what}: {'refused: ' + why if why else 'runs'}")

    # 2. the main path: int8 serving in the parity tier
    params = init_encoder_params(vcfg, torch.Generator().manual_seed(seed))
    knobs = session_kwargs(ap.Namespace(serving_tier="parity", batch_size=4, io_threads=8, quantize_serving=True))
    assert knobs["quantize"] and knobs["encoder_dtype"] == "float32"
    kw = dict(mel=mel, normalize_on_device=True, **knobs)
    d = root / "serve"
    d.mkdir()
    paths = write_inputs(d, mel, np.random.default_rng([seed, 8]))
    cfg_path = d / "config.json"
    cpu = EncoderSession(**kw, device="cpu").load(params)
    Zc, okc, _ = cpu.encode_paths(paths)
    write_config(cfg_path, Zc)
    decc = [detect_species(p, cpu, cfg_path)[:2] for p in paths]
    sess = EncoderSession(**kw, device="cuda").load(params)
    f32 = EncoderSession(**dict(kw, quantize=False), device="cuda").load(params)
    reset_launches()
    i8.reset_launches()  # count only the main path from here
    Z, ok, err = sess.encode_paths(paths)
    dec = [detect_species(p, sess, cfg_path)[:2] for p in paths]
    torch.cuda.synchronize()
    launches = {"mel_power_ct": mel_power.launches["mel_power_ct"], **i8.launches()}
    log(f"[main-path int8 parity DEFAULT_MEL] encode_paths + detect_species, {len(paths)} WAVs: launches "
        f"{launches} (all mel counters {dict(mel_power.launches)}); key {session_fingerprint(sess)}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"int8 main path: a kernel did not launch: {launches}")
    if not (ok.all() and okc.all()) or Z.shape != (len(paths), 128) or not np.isfinite(Z).all():
        raise AssertionError(f"int8 main path: decode failures or bad latents: {err}")
    cos = live_cosine(Z, Zc, "int8 card vs CPU")
    live = np.linalg.norm(Zc, axis=1) > 0
    rel = np.abs(Z - Zc).max(1)[live] / np.abs(Zc).max(1)[live]
    log(f"[main-path int8] latents vs the same session on the CPU: row rel max {rel.max():.3e} (<= "
        f"{INT8_FREE_REL}), cosine min {cos.min():.6f} (>= {INT8_FREE_COS})")
    if not (rel.max() <= INT8_FREE_REL and cos.min() >= INT8_FREE_COS):
        raise AssertionError("int8 latents on the card drifted from the CPU's")
    Zf, _, _ = f32.encode_paths(paths)
    cos = live_cosine(Z, Zf, "int8 vs f32 on the card")
    l2 = np.linalg.norm(Z - Zf, axis=1)[live] / np.linalg.norm(Zf, axis=1)[live]
    log(f"[main-path int8] int8 vs f32 encoder on the card: cosine min {cos.min():.6f} (> 0.97), rel L2 max "
        f"{l2.max():.4f} (< 0.25)")
    if not (cos.min() > 0.97 and l2.max() < 0.25):
        raise AssertionError("int8 latents drifted from the f32 encoder's past the quantization gates")
    if dec != decc or not dec[0][0]:
        raise AssertionError(f"int8 decisions: card {dec} vs cpu {decc} (chunk 0 sits on a centroid)")
    log(f"[main-path int8] decisions identical to the CPU's: {dec}")
    # the same session with torch's quantization (the reference's _quant_x)
    # before the int8-operand mode: the same codes, so the same latents, bit
    # for bit — what keeps the _q8 cache key's meaning
    import anuraxla_torch.pipeline.session as session_mod

    with torch_quantization():
        Zr, _, _ = sess.encode_paths(paths)
    if not np.array_equal(Z, Zr):
        raise AssertionError(f"int8 latents: quantize-on-load != torch quantization + int8 codes "
                             f"(max {np.abs(Z - Zr).max():.3e})")
    log(f"[main-path int8] latents with the quantization on load equal torch's quantization + the int8-operand "
        f"mode bit for bit ({Z.size} values)")

    # the CLI: exit codes of evaluate-wav against a session built as the CLI builds it
    cli_kw = session_kwargs(evaluate_wav.build_parser().parse_args(
        ["--wav", "x", "--serving-tier", "parity", "--quantize-serving"]))
    cli_sess = EncoderSession(mel=mel, device="cuda", init_seed=seed, **cli_kw).load()
    cli_cfg = write_config(d / "cli.json", cli_sess.encode_paths(paths)[0])
    want = [0 if detect_species(p, cli_sess, cli_cfg)[0] else 2 for p in paths]
    codes = []
    for p in paths:
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                evaluate_wav.main(["--wav", str(p), "--config", str(cli_cfg), "--serving-tier", "parity",
                                   "--quantize-serving", "--init-seed", str(seed)])
            except SystemExit as e:
                codes.append(e.code)
    if codes != want or want[0] != 0:
        raise AssertionError(f"evaluate-wav --quantize-serving exit codes {codes}, want {want}")
    try:
        evaluate_wav.main(["--wav", str(paths[0]), "--config", str(cli_cfg), "--serving-tier", "balanced",
                           "--quantize-serving", "--init-seed", str(seed)])
        raise AssertionError("evaluate-wav --serving-tier balanced --quantize-serving was not refused")
    except ValueError as e:
        refused = str(e)
    log(f"[int8-path] evaluate-wav --serving-tier parity --quantize-serving exit codes {codes} (= the session's "
        f"decisions); --serving-tier balanced --quantize-serving refused: {refused}")

    # batch-mate independence: a row alone and beside loud rows (tests/test_quant.py:62)
    q = sess._q
    x = torch.randn(4, *vcfg.input_hw, 1, generator=gen, device="cuda")
    with torch.inference_mode():
        alone = encoder_apply_quantized(q, vcfg, x[:1])["mu"]
        mixed = encoder_apply_quantized(q, vcfg, torch.cat([x[:1], 50.0 * x[1:]]))["mu"]
    diff = (alone[0] - mixed[0]).abs().max().item()
    log(f"[int8-path] batch-mate independence on the card: max|alone - mixed| = {diff:.3e} (<= 1e-5)")
    if not diff <= 1e-5:
        raise AssertionError("int8 latents depend on their batch-mates on the card")

    # 3. ingest at full width
    layers = []
    chans = (1, 32, 64, 128, 256)
    for a, b in zip(chans[:-1], chans[1:]):
        layers += [{"_target_": "torch.nn.Conv2d", "_args_": [a, b, 3], "stride": 2, "padding": 1},
                   {"_target_": "torch.nn.GroupNorm", "_args_": [8, b]}, {"_target_": "torch.nn.SiLU"},
                   {"_target_": "torch.nn.Conv2d", "_args_": [b, b, 3], "padding": 1},
                   {"_target_": "torch.nn.GroupNorm", "_args_": [8, b]}, {"_target_": "torch.nn.SiLU"}]
    pool = []
    for a, b in zip(chans[:-1], chans[1:]):
        pool += [{"_target_": "torch.nn.Conv2d", "_args_": [a, b, 3], "padding": 1}, {"_target_": "torch.nn.SiLU"},
                 {"_target_": "torch.nn.AvgPool2d", "_args_": [2]}]
    head = [{"_target_": "torch.nn.Flatten"}, {"_target_": "torch.nn.Linear", "_args_": [12 * 4 * 256, 512]},
            {"_target_": "torch.nn.SiLU"}, {"_target_": "torch.nn.Linear", "_args_": [512, 128]}]
    rows = np.stack([read_wav(p)[0] for p in paths])
    served = {}
    for family, body in (("stride", layers), ("avgpool", pool)):
        tree = {"encoder": {"_target_": "torch.nn.Sequential", "_args_": body + head}}
        yml, pt, art = d / f"{family}.yaml", d / f"{family}.pt", d / f"{family}_artifact"
        yml.write_text(yaml.safe_dump(tree))
        torch.manual_seed(seed + 1)
        module = hi.build_nn_module(hi.instantiate_target_tree(tree["encoder"])).eval()
        torch.save({"state_dict": module.state_dict()}, pt)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            ingest_encoder.main(["--pt", str(pt), "--yaml", str(yml), "--out", str(art), "--verify"])
        text = out.getvalue()
        if "✅ verified vs torch module" not in text:
            raise AssertionError(f"ingest-encoder --verify {family}: {text}")
        line = next(ln for ln in text.splitlines() if ln.startswith("✅"))
        # the artifact records the input the ingest found (the smallest target_frames
        # the dense layer admits); the tools serve it at that mel config
        frames = json.loads((art / "encoder.json").read_text())["input_hw"][0]
        s = EncoderSession(mel=mel.replace(target_frames=frames), encoder_dir=art, device="cuda", batch_size=8).load()
        z = s.encode_array(rows)
        with torch.inference_mode():
            m = log_mel_batch(torch.from_numpy(rows).cuda(), s.mel)
        with torch.no_grad():
            ref = module(m[:, None].cpu()).numpy()
        np.testing.assert_allclose(z, ref, rtol=INGEST_RTOL, atol=INGEST_ATOL)
        served[family] = s
        log(f"[ingest] {family}: ingest-encoder --verify on the card {line.split(':', 1)[1].strip()}; "
            f"{s._enc_cfg.downsample} norm={s._enc_cfg.norm} input {s._enc_cfg.input_hw}; served by EncoderSession: "
            f"max|z - torch module| = {np.abs(z - ref).max():.3e} (rtol {INGEST_RTOL}, atol {INGEST_ATOL})")
    s = served["avgpool"]
    sq = EncoderSession(mel=s.mel, encoder_dir=d / "avgpool_artifact", device="cuda", batch_size=8,
                        quantize=True).load()
    zf, zq = s.encode_array(rows), sq.encode_array(rows)
    cos = live_cosine(zq, zf, "ingested avgpool int8 vs f32")
    l2 = np.linalg.norm(zq - zf, axis=1) / np.maximum(np.linalg.norm(zf, axis=1), 1e-30)
    log(f"[ingest] the ingested avgpool encoder served int8: cosine min {cos.min():.6f} (> 0.97), rel L2 max "
        f"{l2[np.linalg.norm(zf, axis=1) > 0].max():.4f} (< 0.25)")
    if not (cos.min() > 0.97 and l2[np.linalg.norm(zf, axis=1) > 0].max() < 0.25):
        raise AssertionError("the ingested avgpool encoder drifted past the int8 gates")
    torch.manual_seed(seed + 2)
    dec_mod = FullWidthDecoder().eval()
    pt, art = d / "decoder.pt", d / "decoder_artifact"
    torch.save(dec_mod, pt)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ingest_decoder.main(["--pt", str(pt), "--out", str(art), "--verify"])
    if "✅ verified vs torch module" not in out.getvalue():
        raise AssertionError(f"ingest-decoder --verify: {out.getvalue()}")
    state, spec = load_decoder(art)
    dec = IngestedDecoder(spec)
    dec.load_state_dict(state)
    zl = torch.randn(4, 128, generator=torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        got = dec.cuda()(zl.cuda()).cpu().numpy()
        want_r = dec_mod(zl).numpy()
    derr = np.abs(np.moveaxis(got, -1, 1) - want_r).max()
    log(f"[ingest] decoder: ingest-decoder --verify on the card; spec stack {list(spec.stack)}, out {spec.out_hw}; "
        f"the artifact on the card vs the pickled module: max|diff| = {derr:.3e} (<= 1e-4)")
    if not derr <= 1e-4:
        raise AssertionError("the ingested decoder does not reproduce its module")
    del served, s, sq, dec

    # 4. times at B = 1024: each int8 layer in both operand modes, the
    # encoder a batch, encode_array
    times = {}
    B = TIMING_B
    for name, shape in int8_layers(vcfg):
        ops = int8_operands(shape, B, gen)
        codes = int8_codes(ops)
        packed = i8.pack_weight(ops[1]) if i8.wgmma_tile(ops[1].numel() // ops[1].shape[-1], ops[1].shape[-1],
                                                         dense=len(shape) == 2) else None
        t = {"pr10_ms": PR10_INT8_MS[name]}
        for mode, o, f32 in (("f32", ops, True), ("int8", codes, False)):
            flops, nbytes = int8_work(shape, B, f32=f32)
            t_ops, t_bytes = flops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
            t[mode] = {"ms": cuda_ms(lambda: int8_call(shape, o, packed=packed), iters=10),
                       "plain_ms": cuda_ms(lambda: int8_call(shape, o, plain=True), iters=2, warmup=1),
                       "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                       "gops": flops / 1e9, "gb": nbytes / 1e9, "tile": int8_tile(shape, B)}
        # the yardstick of the f32 mode: torch's quantization, then the kernel on the codes
        t["route_ms"] = cuda_ms(lambda: int8_call(shape, int8_codes(ops), packed=packed), iters=5)
        lib, why = int8_library(shape, codes)
        t["library_route_ms"] = cuda_ms(lib, iters=5) if lib else None
        if lib is not None:  # a yardstick, not a gate: how far the library's sums are from exact
            a = patches_of(shape, codes)
            acc = torch._int_mm(a.reshape(-1, a.shape[-1]), codes[1].reshape(a.shape[-1], -1))
            exact = int8_call(shape, codes, raw=True, packed=packed).reshape(acc.shape)
            t["route_int32_wrong"] = int((acc != exact).sum())
            t["route_int32_max_diff"] = int((acc.long() - exact.long()).abs().max())
            t["route_f32_wrong"] = int((lib() != int8_call(shape, codes, packed=packed)).sum())
            del a, acc, exact
        xf = codes[0].float()
        with exact_f32():
            if len(shape) == 2:
                wf = codes[1].float()
                t["f32_ms"] = cuda_ms(lambda: xf @ wf, iters=5)
                xb, wb = xf.bfloat16(), wf.bfloat16()
                t["bf16_ms"] = cuda_ms(lambda: xb @ wb, iters=5)
                t["library_ms"] = cuda_ms(lambda: torch._int_mm(codes[0], codes[1]), iters=5)
            else:
                (pt_, pb), (pl, pr) = shape[5]
                xf = torch.nn.functional.pad(xf.permute(0, 3, 1, 2), (pl, pr, pt_, pb)).contiguous(
                    memory_format=torch.channels_last)
                wf = codes[1].float().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                conv = lambda a, b: torch.nn.functional.conv2d(a, b, stride=shape[4])  # noqa: E731
                t["f32_ms"] = cuda_ms(lambda: conv(xf, wf), iters=5)
                xb, wb = xf.bfloat16(), wf.bfloat16()
                t["bf16_ms"] = cuda_ms(lambda: conv(xb, wb), iters=5)
                t["library_ms"] = None  # no one PyTorch call computes an int8 conv on the card
        times[name] = t
        route = (f"{t['library_route_ms']:.3f} ms, its int32 sums off the exact ones at {t['route_int32_wrong']} of "
                 f"{exact_n(shape, B)} outputs (max {t['route_int32_max_diff']}), its f32 output off the kernel's at "
                 f"{t['route_f32_wrong']}" if t["library_route_ms"] is not None else f"refused ({why})")
        modes = "; ".join(
            f"{mode} x: kernel {t[mode]['ms']:.4f} ms, plain {t[mode]['plain_ms']:.3f} ms, bound "
            f"{t[mode]['bound_ms']:.4f} ms by {t[mode]['bound_by']} ({t[mode]['gops']:.2f} G int8 ops, "
            f"{t[mode]['gb']:.4f} GB) = {100 * t[mode]['bound_ms'] / t[mode]['ms']:.2f}% of bound [{t[mode]['tile']}]"
            for mode in ("f32", "int8"))
        log(f"[times] int8 {name} {shape} B={B}: {modes}; PR 10's kernel (int8 x) {t['pr10_ms']:.3f} ms; torch "
            f"quantization + the kernel on the codes {t['route_ms']:.4f} ms; library route (patches + torch._int_mm + "
            f"epilogue) {route}" + (f", torch._int_mm alone {t['library_ms']:.3f} ms" if t["library_ms"] is not None
                                    else "")
            + f"; cuDNN / cuBLAS f32 {t['f32_ms']:.3f} ms, bf16 {t['bf16_ms']:.3f} ms (NHWC, TF32 off); {smi}")
        del ops, codes, xf, xb, wf, wb, packed
    convs = [v for k, v in times.items() if k != "Dense_0"]
    dn = times["Dense_0"]
    log(f"[times] int8 layers summed, B={B}: 8 convs f32 x {sum(v['f32']['ms'] for v in convs):.4f} ms (bound "
        f"{sum(v['f32']['bound_ms'] for v in convs):.4f}), int8 x {sum(v['int8']['ms'] for v in convs):.4f} ms (bound "
        f"{sum(v['int8']['bound_ms'] for v in convs):.4f}; PR 10 {sum(v['pr10_ms'] for v in convs):.3f}), torch "
        f"quantization + kernel {sum(v['route_ms'] for v in convs):.4f} ms; dense f32 x {dn['f32']['ms']:.4f} ms, "
        f"int8 x {dn['int8']['ms']:.4f} ms (PR 10 {dn['pr10_ms']:.3f}); 8 convs + dense f32 x "
        f"{sum(v['f32']['ms'] for v in times.values()):.4f} ms, int8 x {sum(v['int8']['ms'] for v in times.values()):.4f}"
        f" ms; f32 convs {sum(v['f32_ms'] for v in convs):.3f}, bf16 convs {sum(v['bf16_ms'] for v in convs):.3f} ms; "
        f"{smi}")
    if not (sum(v["int8"]["ms"] for v in times.values()) <= sum(v["pr10_ms"] for v in times.values())
            and dn["int8"]["ms"] <= dn["pr10_ms"]):
        raise AssertionError("int8 layers in the int8-operand mode slower than PR 10's kernel")

    x = torch.randn(B, *vcfg.input_hw, 1, generator=gen, device="cuda")
    enc = {dt: ConvVAEEncoder(dc.replace(vcfg, dtype=dt)) for dt in ("float32", "bfloat16")}
    for e in enc.values():
        e.load_state_dict(params)
        e.eval().cuda()
    q = quantize_encoder(params, vcfg, device="cuda")
    with torch.inference_mode():
        fused = encoder_apply_quantized(q, vcfg, x)["mu"]
        with torch_quantization():
            if not torch.equal(fused, encoder_apply_quantized(q, vcfg, x)["mu"]):
                raise AssertionError("int8 encoder: quantize-on-load != torch quantization + int8 codes at B=1024")
            route_ms = cuda_ms(lambda: encoder_apply_quantized(q, vcfg, x), iters=5)
        enc_ms = {"int8": cuda_ms(lambda: encoder_apply_quantized(q, vcfg, x), iters=5),
                  "int8 torch quantization": route_ms,
                  **{dt: cuda_ms(lambda e=e: e(x), iters=5) for dt, e in enc.items()}}
    times["encoder ms"] = enc_ms
    log(f"[times] encoder a batch of {B} ([192, 64] mels -> 128): int8 {enc_ms['int8']:.3f} ms (quantized on load; "
        f"with torch's quantization before the kernels {enc_ms['int8 torch quantization']:.3f} ms, the same latents "
        f"bit for bit), f32 trunk {enc_ms['float32']:.3f} ms, bf16 trunk {enc_ms['bfloat16']:.3f} ms; {smi}")
    # where the int8 encoder's time goes: the device time of one forward by
    # kernel, and the CUDA kernels it launches, against the same forward with
    # torch's quantization before each contraction (PR 10's sequence)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    prof_rows = {}
    for label, route in (("fused", contextlib.nullcontext), ("torch quantization", torch_quantization)):
        with route(), torch.inference_mode(), tprofile(activities=[ProfilerActivity.CPU,
                                                                   ProfilerActivity.CUDA]) as prof:
            encoder_apply_quantized(q, vcfg, x)
            torch.cuda.synchronize()
        prof_rows[label] = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                                  key=lambda r: -r[1])
    rows_ = prof_rows["fused"]
    total = sum(r[1] for r in rows_)
    n_kernels = {k: sum(r[2] for r in v) for k, v in prof_rows.items()}
    times["int8 encoder profile ms"] = {
        "device total": total, "int8 kernels": sum(r[1] for r in rows_ if "int8_" in r[0]),
        "kernels": n_kernels["fused"], "kernels with torch quantization": n_kernels["torch quantization"]}
    log(f"[times] int8 encoder profile (torch.profiler, one forward, B={B}): device time {total:.3f} ms, of it the "
        f"int8 kernels {times['int8 encoder profile ms']['int8 kernels']:.3f} ms; {n_kernels['fused']} CUDA kernels, "
        f"{n_kernels['torch quantization']} with torch's quantization before each contraction ("
        f"{n_kernels['torch quantization'] - n_kernels['fused']} fewer); top kernels: " + "; ".join(
            f"{k[:70]} {ms:.3f} ms x{n}" for k, ms, n in rows_[:12]))
    if n_kernels["torch quantization"] - n_kernels["fused"] < 36:
        raise AssertionError(f"one int8 forward launches {n_kernels} CUDA kernels: fewer than 36 saved")
    del x, enc, q

    y = pre_pad(mel, test_rows(mel, B, np.random.default_rng([seed, 9])))
    cps = {}
    for label, extra in (("int8", dict(quantize=True)), ("parity", {}), ("balanced", dict(encoder_dtype="bfloat16"))):
        s = EncoderSession(mel=mel, batch_size=B, normalize_on_device=True, pre_padded_host=True, **extra).load(params)
        for _ in range(2):
            s.encode_array(y)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(3):
            Zt = s.encode_array(y)
        dt = (time.perf_counter() - t1) / 3
        if Zt.shape != (B, 128) or not np.isfinite(Zt).all():
            raise AssertionError(f"encode_array {label}: bad latents")
        cps[label] = B / dt
        del s
    times["chunks_per_s"] = cps
    log(f"[times] encode_array B={B} (pre-padded rows, host->device included): " +
        ", ".join(f"{k} {v:.1f}" for k, v in cps.items()) + f" chunks/s; {smi}")
    torch.cuda.empty_cache()
    log(f"[int8-path] passed in {time.perf_counter() - t0:.1f} s")
    return {"errors": errors, "launches": launches, "times": times}


PAR_SHARDS = 4  # data shards of the parallel phase's meshes, all on cuda:0
PAR_QUANTILE_N = 1 << 20  # samples a row of the sharded_quantile pool
# the sharded-vs-unsharded steps, as the JAX suite sets them (tests/test_parallel.py:99): lr 1e-3 after one
# warm-up step at lr 0, so the second step moves a parameter by about lr, 5x the parameters' atol of 2e-4
PAR_TRAIN_LR, PAR_TRAIN_STEPS = 1e-3, 2


def phase_parallel_path(seed: int, fit_root: Path, fit: dict, train_root: Path) -> dict:
    """The parallel path (``anuraxla_torch.parallel``) at full width
    (``DEFAULT_MEL``, default ``VAEConfig``) on the one card: the data
    shards of the in-process mesh are repeated ``cuda:0`` shards, and the
    cross-process level an NCCL group of world size 1.

    1. serving: ``EncoderSession(data_parallel=True)`` over the one card
       (one shard: the single-device path) on the six serving WAVs, bitwise
       the single session, ``mel_power_ct`` counted; then over
       ``PAR_SHARDS`` shards at B = 1024 on the fit phase's 4096 paths: the
       parity tier's latents held to the single session's (rtol 5e-4 / atol
       2e-5), the decisions identical, ``mel_power_ct`` launched
       ``PAR_SHARDS`` times as often; the balanced tier's (bf16 trunk) held
       by cosine, and both timed;
    2. the fits: ``fit_radial_sharded`` and ``fit_map_sharded`` (LDA full;
       QDA diag, shrink 0.1; tau q 0.05) on the fit phase's latents over the
       shards, held to the single-device fits on the card (centroids, rk,
       means 1e-5; logdets, tau 1e-4; decisions identical);
       ``sharded_quantile`` on a [4, 2^20] pool within 1 ulp of
       ``masked_quantile``; all timed against the single-device versions;
    3. ``initialize_multihost`` at world size 1 (NCCL, localhost): ``psum``
       through the group equals the local sum, ``shard_paths_for_host``
       keeps every path; the group is destroyed;
    4. training: two f32 steps of ``make_sharded_train_step`` at B = 64
       over a (2 data x 2 model) mesh, the encoder's dense and heads split,
       held to the unsharded steps with the same noise, the first at lr 0
       (the warm-up) and the second at lr 1e-3: at each step the loss (rtol
       1e-4) and the gradients, read from AdamW's first moment (1e-4 of each
       tensor's max); then the parameters (rtol 2e-3 / atol 2e-4, a fifth of
       the second step's move); ``train-vae --data-parallel`` for 4 steps on
       the training phase's tree equal to the run without the flag;
    5. the CLIs over the shards on the fit phase's project: ``fit-radial
       --data-parallel --allow-init-encoder`` and ``run-qout-grid
       --device-sweep --data-parallel`` against the same without the flag.
    -> {"launches": mel_power_ct launches on the path, "times": {...}}."""
    import argparse as ap
    import csv
    import socket

    from anuraxla_torch.cli import fit_radial as fit_radial_cli
    from anuraxla_torch.cli import run_qout_grid, train_vae
    from anuraxla_torch.cli.common import session_kwargs
    from anuraxla_torch.cli.evaluate_wav import detect_species
    from anuraxla_torch.config import load_config, priority_ranks, read_radial
    from anuraxla_torch.constants import DEFAULT_MEL as cfg
    from anuraxla_torch.detect.gaussian_map import fit_map, map_decide
    from anuraxla_torch.detect.radial import fit_radial, radial_decide
    from anuraxla_torch.models.checkpoint import load_encoder
    from anuraxla_torch.models.train import TrainConfig, create_train_state, make_train_step, step_noise
    from anuraxla_torch.models.vae import VAEConfig
    from anuraxla_torch.ops.frontend import log_mel_batch, mel_to_encoder_input
    from anuraxla_torch.ops.mel_kernel import mel_power, reset_launches
    from anuraxla_torch.ops.quantiles import masked_quantile
    from anuraxla_torch.parallel import mesh as pmesh
    from anuraxla_torch.parallel.fit import fit_map_sharded, fit_radial_sharded, sharded_quantile
    from anuraxla_torch.parallel.multihost import global_mesh, initialize_multihost, shard_paths_for_host
    from anuraxla_torch.parallel.train_sharded import ColumnSplitDense, make_sharded_train_step, shard_state
    from anuraxla_torch.pipeline.dataset import load_wav_batch, scan_species_tree
    from anuraxla_torch.pipeline.session import EncoderSession
    from anuraxla_torch.probes.common import card_line

    smi = card_line()
    times = {}
    shards = [torch.device("cuda", 0)] * PAR_SHARDS
    enc_dir, cfg_path = fit_root / "encoder", fit_root / "config.json"

    def timed(fn, reps: int = 1):
        """-> (fn's last result, the fastest of ``reps`` calls in ms, host
        clock, synchronized)."""
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return out, best

    def tier(name: str, batch: int) -> dict:
        return session_kwargs(ap.Namespace(serving_tier=name, batch_size=batch, io_threads=8, pre_padded_host=True))

    def session(dp: bool, **kw):
        return EncoderSession(mel=cfg, encoder_dir=enc_dir, project_root=fit_root, **dict(kw, data_parallel=dp)).load()

    # 1a. data_parallel over the one visible card: the single-device path, bitwise
    wavs = write_inputs(fit_root, cfg, np.random.default_rng([seed, 10]))
    single, dp1 = session(False, **tier("balanced", 64)), session(True, **tier("balanced", 64))
    if dp1._mesh is not None or pmesh.make_mesh(device="cuda").shape["data"] != torch.cuda.device_count():
        raise AssertionError("a data-parallel session over one card must be the single-device session")
    Zs, _, _ = single.encode_paths(wavs)
    serve_cfg = write_config(fit_root / "serve_config.json", Zs)
    reset_launches()
    Zd, ok, _ = dp1.encode_paths(wavs)
    dec = [detect_species(p, dp1, serve_cfg)[:2] for p in wavs]
    torch.cuda.synchronize()
    launches = mel_power.launches["mel_power_ct"]
    want = [detect_species(p, single, serve_cfg)[:2] for p in wavs]
    log(f"[parallel] data_parallel session over the one card, balanced tier, {len(wavs)} serving WAVs: latents "
        f"bitwise the single session's {np.array_equal(Zd, Zs)}, decisions {dec}; mel_power_ct {launches}")
    if not (ok.all() and np.array_equal(Zd, Zs) and dec == want and launches > 0):
        raise AssertionError(f"data-parallel session over one card: bitwise {np.array_equal(Zd, Zs)}, decisions "
                             f"{dec} vs {want}, launches {launches}")

    # 1b. PAR_SHARDS shards on cuda:0 at B = 1024 over the fit phase's 4096 paths
    files = sorted((fit_root / "chunks").rglob("*.wav"))
    paths = [files[i % len(files)] for i in range(FIT_TIMING_PATHS)]
    species, cent, rk, _ = read_radial(load_config(cfg_path))
    cent, rk = torch.from_numpy(cent).float().cuda(), torch.from_numpy(rk).float().cuda()
    ranks = torch.from_numpy(priority_ranks(species)).cuda()

    def decide(Z: np.ndarray) -> list:
        return [v.cpu() for v in radial_decide(torch.from_numpy(Z).cuda(), cent, rk, ranks)[:2]]

    Zt = {}
    pmesh.set_default_devices(shards)
    try:
        for name in ("parity", "balanced"):
            for dp in (False, True):
                s = session(dp, **tier(name, TIMING_B))
                if dp and s._mesh.shape != {"data": PAR_SHARDS, "model": 1}:
                    raise AssertionError(f"the {PAR_SHARDS}-shard session's mesh is {s._mesh.shape}")
                s.encode_paths(paths[:TIMING_B])  # warm-up: slots, cuDNN's choices, the page cache
                reset_launches()
                (Z, ok, _), ms = timed(lambda: s.encode_paths(paths))
                n = mel_power.launches["mel_power_ct"]
                if not ok.all() or Z.shape != (FIT_TIMING_PATHS, 128) or not np.isfinite(Z).all():
                    raise AssertionError(f"{name} {dp}: decode failures or latents not finite")
                Zt[name, dp] = (Z, n)
                times[f"encode_paths {name} chunks/s, {PAR_SHARDS if dp else 1} shard(s)"] = FIT_TIMING_PATHS / ms * 1e3
                del s
                torch.cuda.empty_cache()
        (Z1, n1), (Z4, n4) = Zt["parity", False], Zt["parity", True]
        d1, d4 = decide(Z1), decide(Z4)
        same = bool(torch.equal(d1[0], d4[0]) and torch.equal(d1[1], d4[1]))
        (B1, m1), (B4, m4) = Zt["balanced", False], Zt["balanced", True]
        cos = live_cosine(B4, B1, "balanced 4 shards vs 1")
        bd1, bd4 = decide(B1), decide(B4)
        log(f"[parallel] encode_paths over {PAR_SHARDS} shards on cuda:0 vs 1, B={TIMING_B}, {FIT_TIMING_PATHS} "
            f"paths: parity max|diff| {np.abs(Z4 - Z1).max():.3e} (rtol 5e-4, atol 2e-5), decisions identical "
            f"{same}; mel_power_ct {n1} -> {n4} (parity), {m1} -> {m4} (balanced); balanced (bf16 trunk) cosine min "
            f"{cos.min():.6f} (>= 0.999), max|diff| {np.abs(B4 - B1).max():.3e}, decisions differ on "
            f"{int((bd1[1] != bd4[1]).sum())} of {FIT_TIMING_PATHS}")
        np.testing.assert_allclose(Z4, Z1, rtol=5e-4, atol=2e-5)
        if not same or n4 != PAR_SHARDS * n1 or m4 != PAR_SHARDS * m1 or not cos.min() >= 0.999:
            raise AssertionError(f"{PAR_SHARDS}-shard session: decisions identical {same}, launches {n1} -> {n4}, "
                                 f"{m1} -> {m4}, balanced cosine {cos.min()}")
        launches += n4 + m4

        # 2. the fits over the shards against the single-device fits on the card
        mesh = pmesh.make_mesh(device="cuda")
        Z, mask = fit["Z"], fit["mask"]
        Zc, mc = torch.from_numpy(Z).cuda(), torch.from_numpy(mask).cuda()
        map_kw = {"lda": dict(cov_type="lda", cov_structure="full", shrink=0.0),
                  "qda": dict(cov_type="qda", cov_structure="diag", shrink=0.1)}
        fits = {}
        for reps in (1, 5):  # the fastest of five after one call of each (it builds cuSOLVER's handles)
            for name, one, sharded in (
                    ("radial", lambda: fit_radial(Zc, mc, 0.95, 0.01),
                     lambda: fit_radial_sharded(Z, mask, 0.95, 0.01, mesh=mesh)),
                    *((name, (lambda kw=kw: fit_map(Zc, mc, priors_mode="empirical", eps=1e-6, tau_q=0.05, **kw)),
                       (lambda kw=kw: fit_map_sharded(Z, mask, mesh=mesh, priors_mode="empirical", eps=1e-6,
                                                      tau_q=0.05, **kw)))
                      for name, kw in map_kw.items())):
                a, ms_one = timed(one, reps)
                b, ms_sh = timed(sharded, reps)
                fits[name] = (a, b)
                times[f"fit {name} ms, 1 / {PAR_SHARDS} shards"] = (ms_one, ms_sh)
        flat = torch.from_numpy(Z[mask]).cuda()
        franks = torch.from_numpy(priority_ranks(fit["species"])).cuda()
        a, b = fits["radial"]
        errs = {"centroids": row_rel_err(b.centroids.cpu().numpy(), a.centroids.cpu().numpy()),
                "rk": float((b.rk / a.rk - 1).abs().max())}
        ra, rb = radial_decide(flat, a.centroids, a.rk, franks), radial_decide(flat, b.centroids, b.rk, franks)
        same = [bool(torch.equal(ra[0], rb[0]) and torch.equal(ra[1], rb[1]))]
        for name in map_kw:
            a, b = fits[name]
            errs[f"{name} means"] = row_rel_err(b.means.cpu().numpy(), a.means.cpu().numpy())
            errs[f"{name} logdets"] = float((b.logdets / a.logdets - 1).abs().max())
            errs[f"{name} tau"] = abs(float(b.tau) / float(a.tau) - 1)
            ma = map_decide(flat, a.means, a.precisions, a.logdets, a.priors, a.tau)
            mb = map_decide(flat, b.means, b.precisions, b.logdets, b.priors, b.tau)
            same.append(bool(torch.equal(ma[0], mb[0]) and torch.equal(ma[1], mb[1])))
        gates = {k: (FIT_RTOL_LOGDET if ("logdet" in k or "tau" in k) else FIT_RTOL) for k in errs}
        bad = {k: v for k, v in errs.items() if not v <= gates[k]}
        log(f"[parallel] sharded fits over {PAR_SHARDS} shards vs single-device on the card, {int(mask.sum())} "
            f"latents: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (gates {FIT_RTOL} / {FIT_RTOL_LOGDET}); decisions identical (radial, lda, qda) {same}")
        if bad or not all(same):
            raise AssertionError(f"sharded fits disagree with the single-device fits: {bad}, decisions {same}")

        g = torch.Generator(device="cuda").manual_seed(seed + 10)
        d = torch.rand((4, PAR_QUANTILE_N), generator=g, device="cuda") * 7.0
        d[2] = torch.round(d[2] * 2.0) / 2.0  # heavy ties
        qmask = torch.rand((4, PAR_QUANTILE_N), generator=g, device="cuda") > 0.1
        for q in (0.05, 0.3337, 0.95):
            got, ms_sh = timed(lambda: sharded_quantile(d, qmask, q, mesh=mesh), 4)
            ref, ms_sort = timed(lambda: masked_quantile(d, qmask, q), 4)
            rel = float(((got - ref).abs() / ref.abs()).max())
            times[f"sharded_quantile q={q} ms vs sort"] = (ms_sh, ms_sort)
            log(f"[parallel] sharded_quantile q={q} on [4, {PAR_QUANTILE_N}] over {PAR_SHARDS} shards: max rel diff to "
                f"masked_quantile {rel:.3e} (1 ulp: rtol 3e-7); {ms_sh:.2f} ms vs the sort {ms_sort:.2f} ms")
            np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=3e-7, atol=0.0)
    finally:
        pmesh.set_default_devices(None)

    # 3. an NCCL group of world size 1 on localhost
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    joined = initialize_multihost(f"localhost:{port}", num_processes=1, process_id=0, device="cuda")
    try:
        gm = global_mesh(device="cuda")
        t = torch.arange(1.0, 5.0, device="cuda")
        summed = pmesh.psum([t, 2 * t], gm)
        kept = shard_paths_for_host(paths)
        log(f"[parallel] initialize_multihost (NCCL, world 1): joined {joined}, backend "
            f"{torch.distributed.get_backend()}, mesh {gm.shape}, psum through the group {summed.tolist()}, "
            f"shard_paths_for_host keeps {len(kept)} of {len(paths)}")
        if not (joined and gm.group is not None and torch.equal(summed, 3 * t) and kept == paths):
            raise AssertionError("world-size-1 NCCL group: psum or the path shard is wrong")
    finally:
        torch.distributed.destroy_process_group()

    # 4. one sharded f32 train step (2 data x 2 model shards) against the unsharded one
    tfiles = sorted(p for ws in scan_species_tree(train_root / "train_chunks").values() for p in ws)
    audio = load_wav_batch(tfiles[:TRAIN_B], sr=cfg.sr, num_samples=cfg.num_samples, num_threads=8).audio
    mel_b = mel_to_encoder_input(log_mel_batch(torch.from_numpy(audio).cuda(), cfg))
    vcfg, tc = VAEConfig(), TrainConfig(learning_rate=PAR_TRAIN_LR, warmup_steps=1, beta=0.25, kl_delay_steps=0,
                                        kl_warmup_steps=0, seed=seed)
    _, plain = create_train_state(vcfg, tc)
    _, state = create_train_state(vcfg, tc)
    mesh = pmesh.make_mesh(devices=shards, model_axis=2)
    ss, shardings = shard_state(state, mesh)
    split = sorted({k.rpartition(".")[0] for k, v in shardings.items() if v})
    if not {"encoder.dense", "encoder.head_mu", "encoder.head_logvar"} <= set(split) or not isinstance(
            ss.replicas[0].encoder.dense, ColumnSplitDense):
        raise AssertionError(f"model_axis 2 did not split the encoder's dense and heads: {split}")
    plain_step, sharded_step = make_train_step(tc.beta), make_sharded_train_step(tc.beta, mesh)
    pa, pb = dict(plain.model.named_parameters()), dict(ss.state.model.named_parameters())
    p0 = {k: p.detach().clone() for k, p in pa.items()}
    losses, grad_errs = [], []
    for i in range(PAR_TRAIN_STEPS):
        eps = step_noise(seed, i, (TRAIN_B, vcfg.latent_dim), "cuda")
        plain, pm = plain_step(plain, mel_b, eps)
        ss, sm = sharded_step(ss, mel_b, eps)
        losses.append((float(sm["loss"]), float(pm["loss"])))
        grad_errs.append(max(
            float((ss.state.optimizer.state[pb[k]]["exp_avg"] - plain.optimizer.state[pa[k]]["exp_avg"]).abs().max()
                  / plain.optimizer.state[pa[k]]["exp_avg"].abs().max().clamp_min(1e-30)) for k in pa))
    loss_rel = max(abs(b / a - 1) for b, a in losses)
    grad_err = max(grad_errs)
    moved = {k: float((pa[k].detach() - p0[k]).abs().max()) for k in pa}
    param_err = max(float(((pb[k] - pa[k]).abs() - 2e-3 * pa[k].abs()).max().detach()) for k in pa)
    log(f"[parallel] sharded train steps, B={TRAIN_B}, mesh {mesh.shape} on cuda:0, split {split}, lr 0 then "
        f"{PAR_TRAIN_LR}: losses (sharded, unsharded) {losses} (max rel {loss_rel:.2e}, rtol 1e-4); gradients "
        f"(AdamW's first moment) {', '.join(f'{e:.3e}' for e in grad_errs)} of each tensor's max (1e-4); "
        f"parameters max(|diff| - 2e-3|p|) {param_err:.3e} (atol 2e-4), the unsharded step moved each tensor's "
        f"elements by at most {min(moved.values()):.3e} .. {max(moved.values()):.3e}")
    for k in pa:
        np.testing.assert_allclose(pb[k].detach().cpu().numpy(), pa[k].detach().cpu().numpy(), rtol=2e-3,
                                   atol=2e-4, err_msg=k)
    if not (loss_rel <= 1e-4 and grad_err <= 1e-4):
        raise AssertionError(f"sharded train steps: loss rel {loss_rel}, gradients {grad_errs}")
    times["train step ms, unsharded / 2x2 shards"] = (timed(lambda: plain_step(plain, mel_b, eps), 5)[1],
                                                      timed(lambda: sharded_step(ss, mel_b, eps), 5)[1])

    # train-vae --data-parallel on one card: the run without the flag
    outs = {}
    with contextlib.chdir(train_root), torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                                  deterministic=True, allow_tf32=False):
        for flag in ([], ["--data-parallel"]):
            buf = io.StringIO()
            reset_launches()
            with contextlib.redirect_stdout(buf):
                train_vae.main(["--root", "train_chunks", "--batch-size", str(TRAIN_B), "--io-threads", "8",
                                "--steps", "4", "--seed", str(seed), "--out", f"par{len(flag)}", *flag])
            final = re.search(r"final (\{.*\})$", buf.getvalue(), re.M).group(1)
            outs[bool(flag)] = (final, load_encoder(train_root / f"par{len(flag)}")[0],
                                mel_power.launches["mel_power_ct"])
    (f0, e0, l0), (f1, e1, l1) = outs[False], outs[True]
    same = f0 == f1 and all(torch.equal(e0[k], e1[k]) for k in e0)
    log(f"[parallel] train-vae 4 steps with and without --data-parallel (one card, deterministic cuDNN): final "
        f"{f1} vs {f0}, artifacts bitwise {same}; mel_power_ct {l1} / {l0}")
    if not same or l1 != 4:
        raise AssertionError("train-vae --data-parallel on one card differs from the run without the flag")
    launches += l1

    # 5. the CLIs over the shards on the fit phase's project
    common = ["--config", str(cfg_path), "--encoder", str(enc_dir), "--io-threads", "8", "--batch-size", "64"]
    cfgs, grids, cli_launches = {}, {}, {}
    pmesh.set_default_devices(shards)
    try:
        with contextlib.chdir(fit_root):
            for flag in ([], ["--data-parallel", "--allow-init-encoder"]):
                buf = io.StringIO()
                reset_launches()
                with contextlib.redirect_stdout(buf):
                    fit_radial_cli.main(["--root", "chunks", "--q-in", "0.95", "--q-out", "0.01", *common, *flag])
                    cfgs[bool(flag)] = read_radial(load_config(cfg_path))
                    run_qout_grid.main(["--train-root", "chunks", "--val-root", "val", "--grid-root",
                                        f"grid_par{len(flag)}", "--q-out-grid", "0.10", "0.20", "--device-sweep",
                                        "--q-in-grid", "0.90", "0.95", *common, *flag[:1]])
                cli_launches[bool(flag)] = mel_power.launches["mel_power_ct"]
                if flag and "device sweep sharded over 4 shards" not in buf.getvalue():
                    raise AssertionError("run-qout-grid --data-parallel did not shard its device sweep")
                with open(fit_root / f"grid_par{len(flag)}" / "grid_metrics.csv", newline="") as f:
                    grids[bool(flag)] = list(csv.DictReader(f))
    finally:
        pmesh.set_default_devices(None)
    (_, c0, th0, _), (_, c1, th1, _) = cfgs[False], cfgs[True]
    rel, cen = float(np.abs(th1 / th0 - 1).max()), row_rel_err(c1, c0)
    # the padded sweep divides by the valid count where the unpadded one
    # multiplies by its f32 reciprocal: a last-bit difference, which the
    # reference's own test allows (tests/test_parallel.py:361, atol 1e-7);
    # a decision that moved would move a rate by 1/192
    g0, g1 = (np.array([[float(v) for v in row.values()] for row in grids[k]]) for k in (False, True))
    grid_err = float(np.abs(g1 - g0).max()) if g0.shape == g1.shape else float("inf")
    log(f"[parallel] fit-radial with and without --data-parallel --allow-init-encoder over {PAR_SHARDS} shards: "
        f"thresholds rel {rel:.3e}, centroids {cen:.3e} (gate {FIT_RTOL}); run-qout-grid --device-sweep "
        f"({len(grids[True])} points): grid metrics max|diff| {grid_err:.3e} (atol 1e-7); mel_power_ct "
        f"{cli_launches[True]} with the flag, {cli_launches[False]} without")
    if not (rel <= FIT_RTOL and cen <= FIT_RTOL and grid_err <= 1e-7 and cli_launches[True] > 0):
        raise AssertionError(f"the CLIs' numbers moved under --data-parallel: {rel}, {cen}, {grid_err}; "
                             f"launches {cli_launches}")
    launches += cli_launches[True]  # the flagged runs alone: the parallel path's own

    log("[times] parallel path (host clock, synchronized: encode_paths one pass after a warm-up, the fits the "
        "fastest of 5, sharded_quantile and the sort of 4, the train steps of 5 after the gated one; " + smi + "): "
        + "; ".join(
        f"{k} " + (f"{v[0]:.2f} / {v[1]:.2f}" if isinstance(v, tuple) else f"{v:.1f}") for k, v in times.items()))
    return {"launches": launches, "times": times}


PIPELINE_FILES = 48  # make-synth-data --per-species, the scale of the Makefile's e2e-demo recipe
PIPELINE_TRAIN_STEPS = 50  # TRAIN_STEPS of that recipe
PIPELINE_GRID = ("0.10", "0.15", "0.20", "0.25")  # _env.sh's QOUT_GRID default
# the drives that carry a ported diagnostic. This script runs the first: both would add ~180 s to a
# phase of ~130 s (85 and 93 s on the card, perf_logs/pr12/run1_phase10.log);
# perf_logs/pr12/scripts/phase10.py runs the phase with both
PIPELINE_DRIVES = ("drive_fast_tier.sh", "drive_5db_floor.sh")
# the driver's steps, by the line bash -x traces as each starts (the driver's own commands, one '+')
PIPELINE_STEPS = (("01 normalize", "+ bash */01_normalize_chunks.sh"), ("02 train-vae", "+ bash */02_train_vae.sh"),
                  ("fit-map", "+ python -m anuraxla_torch fit-map *"),
                  ("03 encode-wav", "+ bash */03_encode_latents.sh"),
                  ("04 run-qout-grid", "+ bash */04_calibrate_qout_grid.sh"),
                  ("05 benchmarks", "+ bash */05_make_plots.sh"))


def run_script(argv: list, cwd: Path, env: dict, timeout: float = 900) -> tuple:
    """Run ``argv`` to its end, each line of its output and errors stamped
    with the seconds since the start -> (exit code, [(seconds, line)], wall s)."""
    import subprocess

    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, lines, time.perf_counter() - t0


def phase_pipeline_path(seed: int, root: Path, drives=()) -> dict:
    """The port's pipeline driver at full width (``DEFAULT_MEL``, the default
    ``VAEConfig``) in a project of its own, as the Makefile's ``e2e-demo``
    recipe runs the reference's: ``python -m anuraxla_torch make-synth-data
    --per-species 48`` (4 species x 48 WAVs in each of train, val and test),
    then ``bash -x anuraxla_torch/scripts/run_full_pipeline.sh`` with
    ``TRAIN_STEPS=50`` and every other variable at its default (normalize,
    train-vae at B = 64, fit-map --preset small-n, encode-wav --jsonl on three
    splits, run-qout-grid over 4 q_out points with --analyze, benchmark-folder
    and benchmark-folder-map), each step timed by the line its start traces;
    then ``drives`` (of ``PIPELINE_DRIVES``) in that project.
    Gates: the driver exits 0 and leaves every artifact the reference's
    driver documents; the species-tree caches name the card's arithmetic,
    not ``cpuplain``; the val and test latents of the JSONL equal
    ``EncoderSession.encode_paths`` in this process with the trained
    artifact and the flags of ``encode-wav`` (rtol 5e-4 / atol 2e-5; bitwise
    expected, reported); benchmark-folder's decisions equal ``radial_decide``
    on the CPU from those latents and the fitted config.json;
    ``benchmark-folder`` run again in this process with the launch counts set
    to 0 just before and read just after (``mel_power_ct`` moves, no other
    mel kernel does); each drive exits 0, ``decision_diff``'s line parses and
    ``noise_distance``'s table has a row of finite numbers for each species.
    -> {"launches": mel_power_ct's count on the rerun, "times": {...}}."""
    import csv
    import fnmatch
    import os
    import shutil

    from anuraxla_torch.cli import benchmark_folder, encode_wav
    from anuraxla_torch.cli.common import mel_from_args, session_kwargs
    from anuraxla_torch.config import load_config, priority_ranks, read_radial
    from anuraxla_torch.constants import SPECIES
    from anuraxla_torch.detect.radial import radial_decide
    from anuraxla_torch.ops.mel_kernel import mel_power, reset_launches
    from anuraxla_torch.pipeline.dataset import scan_species_tree
    from anuraxla_torch.pipeline.session import EncoderSession
    from anuraxla_torch.probes.common import card_line

    smi = card_line()
    here = Path(__file__).resolve().parent
    scripts = here / "anuraxla_torch" / "scripts"
    (root / "tmp").mkdir()
    driver_vars = {"DEVICE_DEFAULT", "TRAIN_DEVICE", "QOUT_GRID", "MAX_PER_CLASS_DEFAULT", "TRAIN_STEPS",
                   "TRAIN_BATCH", "PROJECT_ROOT", "CHUNKS_ROOT", "TRAIN_CHUNKS", "VAL_CHUNKS", "TEST_CHUNKS",
                   "MODELS_DIR", "OUTPUTS_DIR", "ENCODER_DIR", "CONFIG_JSON", "GRID_ROOT", "MAP_FIT_ARGS"}
    env = {k: v for k, v in os.environ.items() if k not in driver_vars}
    env.update(PYTHONPATH=os.pathsep.join(filter(None, [str(here), env.get("PYTHONPATH")])), PYTHONUNBUFFERED="1",
               TMPDIR=str(root / "tmp"))
    times = {}

    def check(rc: int, lines: list, what: str) -> str:
        out = "\n".join(line for _, line in lines)
        if rc != 0:
            raise AssertionError(f"pipeline path: {what} exited {rc}:\n" + "\n".join(out.splitlines()[-40:]))
        return out

    # the Makefile's e2e-demo recipe
    (root / "models").mkdir()
    rc, lines, times["make-synth-data s"] = run_script(
        [sys.executable, "-m", "anuraxla_torch", "make-synth-data", "--root", "latent_space_exploration",
         "--per-species", str(PIPELINE_FILES), "--seed", str(seed)], root, env)
    check(rc, lines, "make-synth-data")
    shutil.copy(root / "latent_space_exploration" / "config.json", root / "config.json")
    rc, lines, wall = run_script(["bash", "-x", str(scripts / "run_full_pipeline.sh")], root,
                                 {**env, "TRAIN_STEPS": str(PIPELINE_TRAIN_STEPS)})
    out = check(rc, lines, "run_full_pipeline.sh")
    (root / "driver.log").write_text(out + "\n")
    starts = [(name, t) for t, line in lines for name, mark in PIPELINE_STEPS if fnmatch.fnmatchcase(line, mark)]
    if [n for n, _ in starts] != [n for n, _ in PIPELINE_STEPS]:
        raise AssertionError(f"pipeline path: the driver ran the steps {[n for n, _ in starts]}")
    times["driver s"] = wall
    times["preflight s"] = starts[0][1]
    for (name, t), nxt in zip(starts, [t for _, t in starts[1:]] + [wall]):
        times[f"{name} s"] = nxt - t
    m = re.search(r"🏁 (\d+) steps in ([\d.]+)s \(([\d.]+) examples/s\)", out)
    if not m or int(m.group(1)) != PIPELINE_TRAIN_STEPS:
        raise AssertionError("pipeline path: train-vae printed no rate for its steps")
    times["train-vae examples/s"] = float(m.group(3))
    log(f"[pipeline] make-synth-data --per-species {PIPELINE_FILES} + run_full_pipeline.sh (TRAIN_STEPS="
        f"{PIPELINE_TRAIN_STEPS}, every other variable at its default) exit 0 in {wall:.2f} s; "
        + ", ".join(f"{n} {times[f'{n} s']:.2f} s" for n, _ in (("preflight", 0), *PIPELINE_STEPS))
        + f"; train-vae {m.group(1)} steps in {m.group(2)} s = {m.group(3)} examples/s (decode, transfer and "
        f"start-up included)")

    # every artifact the reference's driver documents
    lse, outputs, cfg_path = root / "latent_space_exploration", root / "outputs", root / "config.json"
    missing = [p for p in (root / "models" / "anuraxla_vae_encoder_v0" / "encoder.msgpack",
                           root / "models" / "anuraxla_vae_encoder_v0" / "encoder.json") if not p.is_file()]
    cfg = load_config(cfg_path)
    if not {"radial_detector", "map_detector"} <= set(cfg):
        missing.append("config.json: radial_detector + map_detector")
    jsonl = {}
    for split in ("train", "val", "test"):
        wavs = sorted(str(p) for wavs in scan_species_tree(lse / f"{split}_chunks_norm").values() for p in wavs)
        rows = [json.loads(line) for line in (outputs / "latents" / f"{split}_latents.jsonl").read_text().splitlines()]
        jsonl[split] = {r["file"]: r["vector"] for r in rows}
        if len(wavs) != len(SPECIES) * PIPELINE_FILES or sorted(jsonl[split]) != wavs or len(rows) != len(wavs):
            missing.append(f"{split}_latents.jsonl: {len(rows)} rows for {len(wavs)} WAVs")
    grids = sorted(outputs.glob("qout_grid_*"))
    if len(grids) != 1:
        raise AssertionError(f"pipeline path: grid roots {grids}")
    for q in PIPELINE_GRID:
        for f in ("run.log", "summary.txt", "results.csv", "config_used.json", "config_snapshot.json"):
            if not (grids[0] / f"qout_{q}" / f).is_file():
                missing.append(f"qout_{q}/{f}")
    if not (grids[0] / "spearman_table.csv").is_file():
        missing.append("spearman_table.csv")
    for name in ("detection_benchmark", "detection_benchmark_map"):
        for f in ("results.csv", "summary.txt"):
            if not (outputs / name / f).is_file():
                missing.append(f"{name}/{f}")
    if missing:
        raise AssertionError(f"pipeline path: artifacts missing or short: {missing}")
    log(f"[pipeline] artifacts: encoder artifact, config.json with both detectors, 3 JSONL x "
        f"{len(SPECIES) * PIPELINE_FILES} rows, {len(PIPELINE_GRID)} grid points + spearman_table.csv, both "
        f"benchmarks' results.csv + summary.txt")

    # the caches name the arithmetic that ran in the driver's processes
    caches = sorted((root / "cache_npz").glob("Z_train_chunks_norm_*.npz"))
    fps = {c.name: str(np.load(c)["mel_fp"]) for c in caches}
    if len(caches) != len(SPECIES) or not all("_torch-cuda_" in fp and "cpuplain" not in fp for fp in fps.values()):
        raise AssertionError(f"pipeline path: the caches do not name the card's arithmetic: {fps}")
    arithmetic = sorted({fp.split("_torch-")[1].split("_e")[0] for fp in fps.values()})
    log(f"[pipeline] species-tree caches {', '.join(fps)}: arithmetic {arithmetic}")

    # the JSONL latents against the session in this process: the trained artifact, encode-wav's flags
    args = encode_wav.build_parser().parse_args(["--root", ".", "--jsonl", "--device", "cuda", "--duration", "5.0"])
    sess = EncoderSession(mel=mel_from_args(args, duration=args.duration), encoder_dir=None, project_root=root,
                          device="cuda", **session_kwargs(args)).load()
    lat = {}
    for split in ("val", "test"):
        Z, files, n_bitwise, err = [], [], 0, 0.0
        for sp, wavs in scan_species_tree(lse / f"{split}_chunks_norm").items():
            Zs, ok, _ = sess.encode_paths(wavs)
            if not ok.all():
                raise AssertionError(f"pipeline path: {split}/{sp}: decode failed in process")
            for w, z in zip(wavs, Zs):
                want = np.asarray(jsonl[split][str(w)], np.float32)
                n_bitwise += [round(float(v), args.precision) for v in z] == jsonl[split][str(w)]
                if not np.allclose(z, want, rtol=5e-4, atol=2e-5):
                    raise AssertionError(f"pipeline path: {split} latent of {w.name} is not the JSONL's")
                err = max(err, float(np.abs(z - want).max()))
            Z.append(Zs)
            files += [str(w) for w in wavs]
        lat[split] = (np.concatenate(Z), files)
        log(f"[pipeline] {split} latents: JSONL vs encode_paths in process on the card, {len(files)} rows: "
            f"{n_bitwise} bitwise at the JSONL's {args.precision} decimals, max|diff| {err:.3e} "
            f"(rtol 5e-4 / atol 2e-5)")

    # benchmark-folder's decisions from those latents and the fitted config.json, on the CPU
    species, cents, thr, _ = read_radial(cfg)
    Z, files = lat["test"]
    det, win, best = radial_decide(torch.from_numpy(Z), *(torch.from_numpy(a) for a in
                                                         (cents, thr, priority_ranks(species))))
    with open(outputs / "detection_benchmark" / "results.csv") as fh:
        rows = {r["file"]: r for r in csv.DictReader(fh)}
    differ = [f for i, f in enumerate(files)
              if (rows[f]["pred_species"], rows[f]["detected"])
              != (species[int(win[i])] if bool(det[i]) else "NO_DETECT", str(bool(det[i])))]
    dist = max(abs(float(rows[f]["best_distance"]) - float(best[i])) / max(float(best[i]), 1e-30)
               for i, f in enumerate(files))
    if differ or sorted(rows) != sorted(files) or dist > 1e-5:
        raise AssertionError(f"pipeline path: benchmark-folder vs radial_decide on the CPU: {len(differ)} "
                             f"decisions differ ({differ[:3]}), distances rel {dist:.3e}")
    log(f"[pipeline] benchmark-folder on test_chunks_norm: {len(files)} decisions equal radial_decide on the CPU "
        f"from the in-process latents and config.json ({int(det.sum())} detected); distances rel {dist:.3e}")

    # benchmark-folder again in this process, the launch counts set to 0 just before
    argv = ["--root", str(lse / "test_chunks_norm"), "--config", str(cfg_path), "--device", "cuda",
            "--out-dir", str(outputs / "detection_benchmark_counted")]
    with contextlib.chdir(root), contextlib.redirect_stdout(io.StringIO()):
        reset_launches()
        benchmark_folder.main(argv)
        torch.cuda.synchronize()
        launches = dict(mel_power.launches)
    with open(outputs / "detection_benchmark_counted" / "results.csv") as fh:
        again = {r["file"]: (r["pred_species"], r["detected"]) for r in csv.DictReader(fh)}
    if launches["mel_power_ct"] == 0 or any(v for k, v in launches.items() if k != "mel_power_ct") \
            or again != {f: (r["pred_species"], r["detected"]) for f, r in rows.items()}:
        raise AssertionError(f"pipeline path: benchmark-folder in process launched {launches}")
    log(f"[pipeline] benchmark-folder in process, counts from 0: {launches} (the decisions the driver's)")

    # the drives that carry a ported diagnostic, in the driven project
    for drive in drives:
        rc, lines, times[f"{drive} s"] = run_script(["bash", str(scripts / drive)], root, env)
        out = check(rc, lines, drive)
        (root / f"{drive}.log").write_text(out + "\n")
        if drive == "drive_fast_tier.sh":
            m = re.search(r"^decision equivalence: (\d+)/(\d+) identical \(([\d.]+)%\)$", out, re.M)
            if not m or int(m.group(2)) != len(SPECIES) * PIPELINE_FILES:
                raise AssertionError("pipeline path: decision_diff printed no equivalence line")
            log(f"[pipeline] {drive}: exit 0 in {times[f'{drive} s']:.2f} s; balanced vs fast tier on val_chunks: "
                f"{m.group(0)}; " + "; ".join(line.strip() for line in out.splitlines()
                                              if line.startswith(("600", "14 dB:", "8 dB:"))))
        else:
            table = {}
            for line in out.splitlines():
                parts = line.split()
                if len(parts) == 5 and parts[0] in SPECIES:
                    table[parts[0]] = [float(v) for v in parts[1:]]
            if sorted(table) != sorted(SPECIES) or not np.isfinite(list(table.values())).all():
                raise AssertionError(f"pipeline path: noise_distance's table {table}")
            log(f"[pipeline] {drive}: exit 0 in {times[f'{drive} s']:.2f} s; 5 dB distances (rk, d_own p50, p10, "
                f"d_best-other p50): " + "; ".join(f"{sp} {v}" for sp, v in table.items()))
    log("[times] pipeline path (host clock, wall seconds of each step and drive; "
        f"{smi}): " + "; ".join(f"{k} {v:.2f}" for k, v in times.items()))
    return {"launches": launches["mel_power_ct"], "times": times}


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
    missing = [src for src, _ in (*KERNELS.values(), *INT8_KERNELS.values(), WINDOW_EXPAND)
               if not (here / src).is_file()]
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
    with tempfile.TemporaryDirectory() as fit_root, tempfile.TemporaryDirectory() as train_root:
        # the fit phase's project serves the evaluation and parallel phases, the training phase's tree the latter
        fit = phase_fit_path(args.seed, np.random.default_rng([args.seed, 6]), Path(fit_root))
        evaluation = phase_eval_path(args.seed, Path(fit_root))
        training = phase_train_path(args.seed, Path(train_root))
        with tempfile.TemporaryDirectory() as tmp:
            int8 = phase_int8_path(args.seed, Path(tmp))
        parallel = phase_parallel_path(args.seed, Path(fit_root), fit, Path(train_root))
    with tempfile.TemporaryDirectory() as tmp:
        pipeline = phase_pipeline_path(args.seed, Path(tmp), drives=PIPELINE_DRIVES[:1])
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
            **({"launches_train_path": training["launches"][name]} if name in training["launches"] else {}),
            "launches_eval_path": evaluation["launches"][name],
            **({"launches_parallel_path": parallel["launches"]} if name == "mel_power_ct" else {}),
            **({"launches_pipeline_path": pipeline["launches"]} if name == "mel_power_ct" else {}),
        })
    for name, (source, replaces) in INT8_KERNELS.items():
        layer = INT8_TIMED_CONV if name == "int8_conv" else "Dense_0"
        t = int8["times"][layer]
        f, q8 = t["f32"], t["int8"]  # the main path quantizes on load: its mode is the line's
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "config": f"default VAEConfig {layer} B={TIMING_B}, f32 x quantized on load",
            "launches": int8["launches"][name], "max_abs_err": int8["errors"][name], "ms": f["ms"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
            "library_ms": t["library_ms"], "tile": f["tile"],
            "int8_x": {"ms": q8["ms"], "plain_ms": q8["plain_ms"], "bound_ms": q8["bound_ms"],
                       "bound_by": q8["bound_by"], "tile": q8["tile"], "pr10_ms": t["pr10_ms"]},
            "torch_quantization_then_kernel_ms": t["route_ms"],
        })
    t = evaluation["times"]["window_expand"]
    kernels.append({
        "name": "window_expand", "route": "cuda", "source": WINDOW_EXPAND[0], "replaces": WINDOW_EXPAND[1],
        "config": t["config"], "launches": evaluation["launches"]["window_expand"], "max_abs_err": 0.0,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "tile": "256 threads x 4 columns, float4 stores",
    })
    from anuraxla_torch.probes.common import card_line

    smi = card_line()
    cps = times["chunks_per_s"]
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s; chunks/s at B=1024: "
        f"balanced {cps['balanced']:.1f}, fast {cps['fast']:.1f}; encode_paths (balanced): "
        + ", ".join(f"{k} {v:.1f}" for k, v in fit["chunks_per_s"].items())
        + f"; fleet scan {evaluation['times']['scan windows/s']:.1f} windows/s "
        f"({evaluation['times']['scan realtime x']:.1f}x realtime); train step at B={TRAIN_B}: "
        + ", ".join(f"{k.split()[2]} {v['examples/s']:.1f}" for k, v in training["times"].items()
                    if k.startswith("train step")) + " examples/s (host-bound), "
        + ", ".join(f"{k.split()[2]} {v['device examples/s']:.1f}" for k, v in training["times"].items()
                    if k.startswith("train step")) + " (device); int8 encoder "
        + f"{int8['times']['encoder ms']['int8']:.3f} ms a batch of {TIMING_B} ("
        + f"{int8['times']['int8 encoder profile ms']['kernels']} CUDA kernels; f32 "
        + f"{int8['times']['encoder ms']['float32']:.3f}, bf16 {int8['times']['encoder ms']['bfloat16']:.3f}), "
        + "encode_array " + ", ".join(f"{k} {v:.1f}" for k, v in int8["times"]["chunks_per_s"].items())
        + " chunks/s; parallel path " + ", ".join(f"{k} {v:.1f}" for k, v in parallel["times"].items()
                                                  if k.startswith("encode_paths"))
        + f"; pipeline driver {pipeline['times']['driver s']:.1f} s (train-vae "
        + f"{pipeline['times']['train-vae examples/s']:.1f} examples/s), {PIPELINE_DRIVES[0]} "
        + f"{pipeline['times'][PIPELINE_DRIVES[0] + ' s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
