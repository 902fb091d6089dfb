"""A/B timing of split-kernel sources built here: python _proof/ab.py name=path.cu ... (each timed in turn, twice)."""
import ctypes, subprocess, sys, time, numpy as np, torch
from concurrent.futures import ThreadPoolExecutor
sys.path.insert(0, ".")
from anuraxla_torch.constants import DEFAULT_MEL as cfg
from anuraxla_torch.ops import mel_kernel as tk
from anuraxla_torch.ops.frontend import rms_scale_batch
from anuraxla_torch.probes.common import cuda_ms
srcs = dict(a.split("=") for a in sys.argv[1:])
def build(item):
    name, path = item
    text = open(path).read().replace('#include "mel_', '#include "../anuraxla_torch/csrc/mel_')
    open(f"_proof/ab_{name}.cu", "w").write(text)
    r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", f"_proof/libab_{name}.so", f"_proof/ab_{name}.cu"],
                       capture_output=True, text=True)
    regs = [l.strip() for l in r.stderr.splitlines() if "registers" in l or "spill" in l or "C7520" in l]
    return name, r.returncode, r.stderr[-1500:] if r.returncode else regs
with ThreadPoolExecutor(8) as ex:
    for name, rc, info in ex.map(build, srcs.items()):
        print(f"[ab build] {name} rc={rc} {info}", flush=True)
vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
libs = {}
for n in srcs:
    f = ctypes.CDLL(f"_proof/libab_{n}.so").mel_power_ct_split_launch
    f.argtypes = [vp, i64, vp, vp, vp, vp, vp, *[i32] * 10, vp]
    libs[n] = f
B = 1024
rng = np.random.default_rng(0)
y = torch.from_numpy((0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)).cuda()
s = rms_scale_batch(y)
pad = cfg.n_fft // 2
ref = {}
for exact, first, T in ((True, 0, 626), (False, 217, 192)):
    tab, win, wr = tk._tables(cfg, y.device, "ct_fused", exact)
    out = torch.empty(B, T, 64, device="cuda")
    small = tk.mel_power_ct_fused_plain(torch.nn.functional.pad(y[:4], (pad, pad)), s[:4], cfg, T, first_frame=first, exact=exact)
    order = list(srcs) + list(srcs)[::-1]
    for C in (1, 2):
        for n in order:
            def go():
                e = libs[n](y.data_ptr(), y.shape[1], s.data_ptr(), tab.data_ptr(), win.data_ptr(), wr.data_ptr(), out.data_ptr(),
                            B, T, first, pad, 2048, 384, 64, 4, C, int(not exact), torch.cuda.current_stream().cuda_stream)
                assert e == 0, e
            ms = cuda_ms(go, iters=5)
            rel = ((out[:4] - small).abs() / small.abs().amax(dim=(1, 2), keepdim=True)).max().item()
            print(f"[ab] {n} exact={exact} C={C}: {ms:.3f} ms, worst vs plain (4 rows) {rel:.3e}", flush=True)
