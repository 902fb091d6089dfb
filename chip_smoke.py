"""On-card smoke run of the PyTorch/CUDA port (``anuraxla_torch``).

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card, ``nvcc`` and the checkout it sits in. Phases (any
failure exits non-zero):
1. build the Hopper kernels from ``anuraxla_torch/csrc`` (one nvcc each, in
   parallel);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (``DEFAULT_MEL``, B = 64 rows with a silent and a
   clipping row) and at a small config with R != 16;
3. drive the main path — ``EncoderSession.encode_paths`` and
   ``detect_species`` on a few WAVs, f32 and bf16 trunk, backend "cuda",
   fused RMS, pre-padded host rows — with the kernels' launch counts set to 0
   just before and read just after; the f32 latents must match the same
   session on the CPU and the decisions must agree;
4. time ``encode_array`` (chunks/s), each kernel, its plain version, its
   bound and one PyTorch library call computing the same function;
5. print the kernels line, the card's name and power limit, and last the
   device line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
REL_TOL = 2e-5  # kernel vs plain, max over rows of max|diff| / max|plain| (exact tier)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def padded_rows(cfg, B: int, rng: np.random.Generator):
    """[B, num_samples] test signals (row 0 silent, row 1 clips after RMS
    scaling) and their pre-padded layout."""
    from anuraxla_torch.ops.mel_kernel import phase_padded_layout

    y = (0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)
    y[0] = 1e-7 * rng.standard_normal(cfg.num_samples)
    y[1] = 0.001 * rng.standard_normal(cfg.num_samples)
    y[1, :: cfg.num_samples // 50] = 0.9  # sparse spikes >> RMS: clip after scaling
    L_pad, off = phase_padded_layout(cfg, cfg.total_frames)
    yp = np.zeros((B, L_pad), np.float32)
    yp[:, off : off + cfg.num_samples] = y
    return y, yp


def mel_work(cfg, fb: np.ndarray, B: int, L: int):
    """(flops, bytes) the mel function needs for B rows of L samples, counted
    from its least work, not from how the kernel computes it: the RMS scale
    (one multiply a valid sample), the window, a real FFT of n_fft points
    (2.5 n log2 n flops), the power of each bin and the filterbank's nonzero
    products, 2 flops each. Bytes: rows, scales and tables read once, mel
    written once."""
    n_freq = cfg.n_fft // 2 + 1
    flops_frame = (cfg.n_fft + 2.5 * cfg.n_fft * np.log2(cfg.n_fft) + 3 * n_freq
                   + 2 * np.count_nonzero(fb))
    T = cfg.total_frames
    R = cfg.n_fft // 128
    n_half = R // 2 + 1
    tables = (2 * n_half * 128 * 128 + n_half * 128 * cfg.n_mels + cfg.n_fft) * 4
    nbytes = B * L * 4 + B * 4 + tables + B * T * cfg.n_mels * 4
    return float(flops_frame * B * T + B * cfg.num_samples), nbytes


def ct_gemm_flops(cfg, B: int) -> float:
    """FP32 flops the kernel's Cooley-Tukey GEMM form does (dense 128x128
    outer products, merged filterbank, literal-weight inner stage): the
    kernel's own work, printed beside its time; not its bound."""
    R = cfg.n_fft // 128
    fma = 0
    for r in range(R // 2 + 1):
        real = r == 0 or 2 * r == R
        fma += (2 if real else 4) * 128 * 128 + 128 * cfg.n_mels + R * 128 * (1 if real else 2)
    return 2.0 * fma * B * cfg.total_frames


def phase_build() -> None:
    from anuraxla_torch.ops import _build

    t0 = time.perf_counter()
    _build.load("mel_power_ct")
    log(f"[build] mel_power_ct built+loaded in {time.perf_counter() - t0:.2f} s")
    for line in _build.lib_path("mel_power_ct").with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build]   {line.strip()}")


def phase_kernel_vs_plain(rng) -> dict:
    from anuraxla_torch.constants import DEFAULT_MEL, MelConfig
    from anuraxla_torch.ops.frontend import rms_scale_batch
    from anuraxla_torch.ops.mel_kernel import mel_power, mel_power_ct_plain

    small = MelConfig(sr=16000, duration=0.5, n_mels=32, fmin=100, fmax=7500,
                      hop_length=128, n_fft=256, target_frames=48)
    result = {}
    for name, cfg, B in (("DEFAULT_MEL", DEFAULT_MEL, 64), ("n_fft256_hop128", small, 8)):
        y, yp = padded_rows(cfg, B, rng)
        dev = torch.from_numpy(yp).cuda()
        s = rms_scale_batch(torch.from_numpy(y).cuda())
        assert float(s[0]) == -1.0 and float(s[1]) > 0, s[:2]
        T = cfg.total_frames
        got = mel_power(dev, cfg, num_frames=T, rms_scale=s, pre_padded=True)
        ref = mel_power_ct_plain(dev, s, cfg, T)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: kernel output not finite")
        abs_err = float((got - ref).abs().max())
        # each row against its own max, so the silent row (mel power ~1e-12
        # of the others, raw passthrough) is held to the same bound
        row_rel = (got - ref).abs().amax(dim=(1, 2)) / ref.abs().amax(dim=(1, 2))
        rel = float(row_rel.max())
        log(f"[kernel-vs-plain] {name} B={B} T={T}: max|diff|={abs_err:.3e} "
            f"max over rows of max|diff|/max={rel:.3e} (silent row {float(row_rel[0]):.3e}, "
            f"clipping row {float(row_rel[1]):.3e}; tol {REL_TOL})")
        if not rel <= REL_TOL:
            raise AssertionError(f"{name}: kernel disagrees with plain version ({rel:.3e})")
        result[name] = (abs_err, rel)
    return result["DEFAULT_MEL"]


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


def write_config(d: Path, Z: np.ndarray) -> Path:
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
    path = d / "config.json"
    path.write_text(json.dumps(cfg))
    return path


def phase_main_path(seed: int, rng) -> int:
    from anuraxla_torch.cli.evaluate_wav import detect_species
    from anuraxla_torch.constants import DEFAULT_MEL
    from anuraxla_torch.models.vae import VAEConfig, init_encoder_params
    from anuraxla_torch.ops.mel_kernel import mel_power
    from anuraxla_torch.pipeline.session import EncoderSession

    params = init_encoder_params(VAEConfig(), torch.Generator().manual_seed(seed))
    common = dict(mel=DEFAULT_MEL, batch_size=4, normalize_on_device=True, pre_padded_host=True)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        paths = write_inputs(d, DEFAULT_MEL, rng)
        s32 = EncoderSession(**common, backend="cuda", device="cuda").load(params)
        s16 = EncoderSession(**common, backend="cuda", device="cuda", encoder_dtype="bfloat16").load(params)
        cpu = EncoderSession(**common, device="cpu").load(params)
        Zc, okc, _ = cpu.encode_paths(paths)
        cfg_path = write_config(d, Zc)

        mel_power.launches = 0  # count only the main path from here
        Z32, ok32, err32 = s32.encode_paths(paths)
        Z16, ok16, _ = s16.encode_paths(paths)
        dec32 = [detect_species(p, s32, cfg_path) for p in paths]
        dec16 = [detect_species(p, s16, cfg_path) for p in paths]
        torch.cuda.synchronize()
        launches = mel_power.launches
        log(f"[main-path] encode_paths + detect_species, {len(paths)} WAVs x 2 tiers: "
            f"mel_power_ct launches={launches}")
        if launches <= 0:
            raise AssertionError("the main path did not launch the mel kernel")

        if not (ok32.all() and ok16.all() and okc.all()):
            raise AssertionError(f"decode failures: {err32}")
        if Z32.shape != (len(paths), 128) or not np.isfinite(Z32).all() or not np.isfinite(Z16).all():
            raise AssertionError("latents not finite or of the wrong shape")
        np.testing.assert_allclose(Z32, Zc, rtol=5e-4, atol=2e-5)
        log(f"[main-path] f32 latents vs CPU: max|diff|={np.abs(Z32 - Zc).max():.3e} (rtol 5e-4, atol 2e-5)")
        decc = [detect_species(p, cpu, cfg_path) for p in paths]
        if [x[:2] for x in dec32] != [x[:2] for x in decc]:
            raise AssertionError(f"decisions differ: cuda {dec32} vs cpu {decc}")
        log(f"[main-path] decisions (f32, identical to CPU): {[x[:2] for x in dec32]}")
        if not dec32[0][0]:
            raise AssertionError("chunk 0 sits on a centroid and must be detected")
        # a chunk that standardizes to an all-zero mel gives mu = 0 in both
        # tiers (zero biases); the cosine is taken over the other chunks
        n32, n16 = np.linalg.norm(Z32, axis=1), np.linalg.norm(Z16, axis=1)
        live = n32 > 0
        if not np.array_equal(live, n16 > 0) or not live.any():
            raise AssertionError(f"zero latents differ between tiers: f32 {n32}, bf16 {n16}")
        cos = (Z16 * Z32).sum(axis=1)[live] / (n16 * n32)[live]
        log(f"[main-path] bf16 vs f32 latent cosine min={cos.min():.6f} (> 0.99) over "
            f"{int(live.sum())} chunks ({int((~live).sum())} zero in both); "
            f"bf16 decisions {[x[:2] for x in dec16]}")
        if not cos.min() > 0.99:
            raise AssertionError("bf16 tier drifted from f32")
    return launches


def phase_times(seed: int, rng, profile: bool = False) -> dict:
    from anuraxla_torch.constants import DEFAULT_MEL as cfg
    from anuraxla_torch.models.vae import VAEConfig, init_encoder_params
    from anuraxla_torch.ops.frontend import log_mel_batch, mel_to_encoder_input, rms_scale_batch
    from anuraxla_torch.ops.mel import mel_filterbank
    from anuraxla_torch.ops.mel_kernel import mel_power, mel_power_ct_plain
    from anuraxla_torch.pipeline.session import EncoderSession

    params = init_encoder_params(VAEConfig(), torch.Generator().manual_seed(seed))
    sess = EncoderSession(mel=cfg, batch_size=1024, normalize_on_device=True,
                          pre_padded_host=True, encoder_dtype="bfloat16").load(params)
    out = {}
    for B in (256, 1024):
        y, yp = padded_rows(cfg, B, rng)
        for _ in range(2):  # warm-up; allocates both pinned host buffers
            sess.encode_array(yp)
        torch.cuda.synchronize()
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            Z = sess.encode_array(yp)
        dt = (time.perf_counter() - t0) / reps
        assert Z.shape == (B, 128) and np.isfinite(Z).all()
        out[f"chunks_per_s_B{B}"] = B / dt
        log(f"[times] encode_array B={B} (pre-padded, bf16 trunk, host->device included): "
            f"{dt * 1e3:.2f} ms/batch = {B / dt:.1f} chunks/s")

    # where a served batch's time goes, B = 1024: host rows -> device, then
    # the device forward split into frontend (RMS + mel kernel + epilogue)
    # and encoder
    B = 1024
    y, yp = padded_rows(cfg, B, rng)
    t0 = time.perf_counter()
    dev = sess._to_device(yp)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: sess._forward(dev), iters=5)
        s = rms_scale_batch(dev[:, cfg.n_fft // 2 : cfg.n_fft // 2 + cfg.num_samples])
        front = lambda: log_mel_batch(dev, cfg, rms_scale=s, pre_padded=True)  # noqa: E731
        front_ms = cuda_ms(front, iters=5)
        x = mel_to_encoder_input(front())
        enc_ms = cuda_ms(lambda: sess._enc(x), iters=5)
        if profile:
            from torch.profiler import ProfilerActivity, profile as tprofile

            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                sess._forward(dev)
                torch.cuda.synchronize()
            log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))
    log(f"[times] B={B} breakdown: host->device (pinned copy + transfer) {h2d_ms:.2f} ms, "
        f"device forward {fwd_ms:.3f} ms = {B / fwd_ms * 1e3:.1f} chunks/s "
        f"(frontend {front_ms:.3f} ms, encoder bf16 {enc_ms:.3f} ms)")
    T = cfg.total_frames
    launches0 = mel_power.launches
    ms = cuda_ms(lambda: mel_power(dev, cfg, num_frames=T, rms_scale=s, pre_padded=True), iters=10)
    plain_ms = cuda_ms(lambda: mel_power_ct_plain(dev, s, cfg, T), iters=2, warmup=1)
    mel_power.launches = launches0  # timing launches are not main-path launches
    fb_np = mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
    flops, nbytes = mel_work(cfg, fb_np, B, dev.shape[1])
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    gemm = ct_gemm_flops(cfg, B)

    # library yardstick (never called by the port): torch.stft -> |.|^2 @ FB
    off = cfg.n_fft // 2
    valid = dev[:, off : off + cfg.num_samples]
    win = torch.hann_window(cfg.n_fft, periodic=True, device="cuda")
    fb = torch.from_numpy(fb_np).cuda()

    def library():
        X = torch.stft(valid, cfg.n_fft, cfg.hop_length, window=win, center=True,
                       pad_mode="constant", onesided=True, return_complex=True)
        return (X.real.square() + X.imag.square()).transpose(1, 2) @ fb

    library_ms = cuda_ms(library, iters=5)
    log(f"[times] mel_power_ct B={B} T={T}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library(torch.stft) {library_ms:.3f} ms (kernel/library {ms / library_ms:.2f}x), "
        f"bound {bound_ms:.3f} ms by {bound_by} (function's least work: {flops / 1e9:.2f} GFLOP "
        f"-> {t_ops:.3f} ms, {nbytes / 1e9:.3f} GB -> {t_bytes:.3f} ms) = {100 * bound_ms / ms:.2f}% of bound; "
        f"the kernel's CT GEMM form does {gemm / 1e12:.3f} TFLOP = {gemm / ms / 1e9:.2f} TFLOP/s FP32")
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print torch.profiler's kernel table for one B=1024 forward")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(1)
    # the port and its kernel sources must sit beside this script
    here = Path(__file__).resolve().parent
    if not (here / "anuraxla_torch" / "csrc" / "mel_power_ct.cu").is_file():
        print(f"chip_smoke: no anuraxla_torch checkout beside {here}", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(here))

    torch.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()
    phase_build()
    abs_err, rel_err = phase_kernel_vs_plain(rng)
    launches = phase_main_path(args.seed, rng)
    times = phase_times(args.seed, rng, args.profile)
    kernels = [{
        "name": "mel_power_ct",
        "route": "cuda",
        "source": "anuraxla_torch/csrc/mel_power_ct.cu",
        "replaces": "anuraxla/ops/pallas_frontend.py:567 (_mel_power_ctp_kernel)",
        "launches": launches,
        "max_abs_err": abs_err,
        "max_rel_err": rel_err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": times["library_ms"],
    }]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s; "
        f"chunks/s B=256 {times['chunks_per_s_B256']:.1f}, B=1024 {times['chunks_per_s_B1024']:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
