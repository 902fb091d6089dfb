"""CUDA-event times of the window expansion kernel at the scan's batch
(B 1 024 x 240 000, 5 s windows at a 2.5 s hop, one file), against its plain
version on the card; bitwise check at the same time."""
import json, os, sys
import numpy as np, torch
sys.path.insert(0, os.getcwd())
from anuraxla_torch.ops.window_expand import window_expand, window_expand_plain

B, L, hop = 1024, 240000, 120000
n = (B - 1) * hop + L
rng = np.random.default_rng(3)
runs = rng.integers(-32768, 32768, n, dtype=np.int16)
table = np.stack([np.arange(B) * hop, np.full(B, L)], 1).astype(np.int32)
slot = torch.from_numpy(np.concatenate([table.view(np.int16).ravel(), runs])).cuda()

def ms(fn, reps):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

k = ms(lambda: window_expand(slot, B, L, L, 0), 50)
p = ms(lambda: window_expand_plain(slot, B, L, L, 0), 3)
eq = bool(torch.equal(window_expand(slot, B, L, L, 0), window_expand_plain(slot, B, L, L, 0)))
bytes_ = B * L * 4 + n * 2
print(json.dumps({"kernel_ms": k, "plain_ms": p, "bitwise": eq, "bound_ms": bytes_ / 3.35e12 * 1e3,
                  "GB_per_s": bytes_ / (k * 1e-3) / 1e9, "device": torch.cuda.get_device_name(0)}))
