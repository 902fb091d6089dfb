"""First chip check of the rewritten split kernel: build, ptxas, correctness at small B, then timings."""
import sys, time, numpy as np, torch
sys.path.insert(0, ".")
from anuraxla_torch.constants import DEFAULT_MEL, MelConfig
from anuraxla_torch.ops import _build, mel_kernel as tk
from anuraxla_torch.ops.frontend import rms_scale_batch
from anuraxla_torch.probes.common import cuda_ms

t0 = time.time()
_build.build(["mel_power_ct_split"])
print(f"[build] {time.time() - t0:.1f} s", flush=True)
print(_build.lib_path("mel_power_ct_split").with_suffix(".log").read_text()[-3000:], flush=True)
small = dict(sr=16000, duration=0.5, n_mels=32, fmin=100, fmax=7500, target_frames=48)
cfgs = {"DEFAULT_MEL": DEFAULT_MEL, "hop320": DEFAULT_MEL.replace(hop_length=320),
        "n_fft256": MelConfig(**small, hop_length=128, n_fft=256),
        "n_fft384_m20": MelConfig(**dict(small, n_mels=20), hop_length=128, n_fft=384),
        "m128": DEFAULT_MEL.replace(n_mels=128), "r8": DEFAULT_MEL.replace(hop_length=512, n_fft=1024)}
rng = np.random.default_rng(0)
bad = 0
for label, B in (("DEFAULT_MEL", 1), ("DEFAULT_MEL", 3), ("DEFAULT_MEL", 8), ("hop320", 5), ("n_fft256", 4),
                 ("n_fft384_m20", 3), ("m128", 4), ("r8", 2)):
    cfg = cfgs[label]
    T = min(cfg.total_frames, 100)
    y = (0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)
    raw = torch.from_numpy(y).cuda()
    s = rms_scale_batch(raw)
    centred = torch.nn.functional.pad(raw, (cfg.n_fft // 2, cfg.n_fft // 2))
    for exact in (True, False):
        try:
            got = tk.mel_power(raw, cfg, num_frames=T, first_frame=3, rms_scale=s, exact=exact, fused_dots=True)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001
            print(f"[check] {label} B={B} exact={exact}: FAILED {type(e).__name__}: {e}", flush=True)
            bad += 1
            if "illegal" in str(e) or "launch failure" in str(e) or "unspecified" in str(e):
                sys.exit(3)
            continue
        ref = tk.mel_power_ct_fused_plain(centred, s, cfg, T, first_frame=3, exact=exact)
        rel = (got - ref).abs() / ref.abs().amax(dim=(1, 2), keepdim=True)
        f32 = tk.mel_power_ct_plain(centred, s, cfg, T, first_frame=3)
        rel32 = ((got - f32).abs() / f32.abs().amax(dim=(1, 2), keepdim=True)).max().item()
        ok = rel.max().item() <= (2e-5 if exact else 3e-3) and rel.mean().item() <= 2e-5 and torch.isfinite(got).all()
        bad += not ok
        print(f"[check] {label} B={B} cluster={tk.ct_fused_cluster(B)} exact={exact}: worst {rel.max().item():.3e} "
              f"mean {rel.mean().item():.3e} vs f32 {rel32:.3e} {'ok' if ok else 'BAD'}", flush=True)
print(f"[check] bad={bad}", flush=True)
if bad:
    sys.exit(1)
cfg = DEFAULT_MEL
for B in (1024,):
    y = (0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)
    raw = torch.from_numpy(y).cuda()
    s = rms_scale_batch(raw)
    for clusters in ((1,), (2, 1), (4, 2, 1)):
        tk.FUSED_CLUSTERS = clusters
        for exact, first, T in ((True, 0, cfg.total_frames), (False, 217, 192)):
            ms = cuda_ms(lambda: tk.mel_power(raw, cfg, num_frames=T, first_frame=first, rms_scale=s, exact=exact,
                                              fused_dots=True), iters=5)
            print(f"[time] B={B} cluster={clusters[0]} exact={exact} frames {first}..{first + T - 1}: {ms:.3f} ms",
                  flush=True)
