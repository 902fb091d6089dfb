"""The conv VAE's train step at B = 64 (default VAEConfig, DEFAULT_MEL's
[192, 64] input), f32 and bf16 trunk, on the card: the host's enqueue time
a step (no synchronisation), the wall time a step (synchronised), and from
torch.profiler the kernels' summed device time and launch count a step, so
the device's busy share is the kernels' time over the wall.

    python perf_logs/pr9/scripts/profile_step.py   (from the repository's root)
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))
import torch
from torch.profiler import ProfilerActivity, profile

from anuraxla_torch.models.train import TrainConfig, create_train_state, make_train_step
from anuraxla_torch.models.vae import VAEConfig
from anuraxla_torch.probes.common import card_line

print(card_line(), torch.__version__, flush=True)
gen = torch.Generator(device="cuda").manual_seed(0)
x = torch.randn(64, 192, 64, 1, device="cuda", generator=gen)
eps = torch.randn(64, 128, device="cuda", generator=gen)
tc = TrainConfig(learning_rate=1e-4, warmup_steps=0, total_steps=1000, beta=0.25, kl_delay_steps=0, kl_warmup_steps=0)
step = make_train_step(tc.beta)
for dtype in ("float32", "bfloat16"):
    _, st = create_train_state(VAEConfig(dtype=dtype), tc)
    for _ in range(5):
        step(st, x, eps)
    torch.cuda.synchronize()
    n = 30
    enq = []
    t0 = time.perf_counter()
    for _ in range(n):
        t1 = time.perf_counter()
        step(st, x, eps)
        enq.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            step(st, x, eps)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.device_time for e in kernels) / 10 / 1e3
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:8]
    print(json.dumps({
        "dtype": dtype, "batch": 64, "wall_ms_per_step": wall, "enqueue_ms_per_step": sum(enq) / n * 1e3,
        "kernels_per_step": len(kernels) / 10, "kernel_ms_per_step": dev_ms, "device_busy_share": dev_ms / wall,
        "top_kernels_ms_per_step": {e.key[:60]: e.self_device_time_total / 10 / 1e3 for e in top},
    }), flush=True)
