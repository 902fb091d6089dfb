"""Timing variants of the split kernel (probe copies of the source, built here): where does a stage's time go?"""
import ctypes, re, subprocess, sys, time, numpy as np, torch
from concurrent.futures import ThreadPoolExecutor
sys.path.insert(0, ".")
from anuraxla_torch.constants import DEFAULT_MEL as cfg
from anuraxla_torch.ops import mel_kernel as tk
from anuraxla_torch.ops.frontend import rms_scale_batch
from anuraxla_torch.probes.common import cuda_ms

src = open("anuraxla_torch/csrc/mel_power_ct_split.cu").read().replace('#include "mel_', '#include "../anuraxla_torch/csrc/mel_')
def variant(name, subs):
    s = src
    for a, b in subs:
        assert a in s, (name, a)
        s = s.replace(a, b)
    open(f"_proof/v_{name}.cu", "w").write(s)
    return name
ARR_OLD = 'mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];'
ARR_NEW = 'mbarrier.arrive.shared::cluster.b64 _, [%0];'
WG = 'wgmma_m64n32k16(acc, desc('
LOCAL_OLD = """    for (uint32_t cta = 0; cta < x.csize; ++cta) mbar_arrive_cluster(bar, cta);"""
LOCAL_NEW = """    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(bar) : "memory");
    for (uint32_t cta = 0; cta < x.csize; ++cta) if (cta != crank_g) mbar_arrive_cluster(bar, cta);"""
names = [
    variant("arrive", [(ARR_OLD, ARR_NEW)]),
    variant("local", [(ARR_OLD, ARR_NEW), (LOCAL_OLD, LOCAL_NEW.replace("crank_g", "cluster_rank()"))]),
    variant("nostages", [(ARR_OLD, ARR_NEW), ("  const int slot = x.it % x.stages;\n  mbar_wait(x.full + 8 * slot, (uint32_t)(x.it / x.stages) & 1);",
                                              "  const int slot = 0;"),
                         ("  if (x.lane == 0) {\n    const uint32_t bar", "  if (x.lane < 0) {\n    const uint32_t bar"),
                         ("      for (int i = 0; i < p.n_stages; ++i) {", "      for (int i = 0; i < 0; ++i) {")]),
]
def build(n):
    r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", f"_proof/libv_{n}.so", f"_proof/v_{n}.cu"],
                       capture_output=True, text=True)
    return n, r.returncode, r.stderr[-800:]
t0 = time.time()
with ThreadPoolExecutor(8) as ex:
    for n, rc, err in ex.map(build, names):
        print(f"[build] {n} rc={rc} {err if rc else ''}", flush=True)
print(f"[build] {time.time() - t0:.1f} s", flush=True)
vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
B = 1024
rng = np.random.default_rng(0)
y = torch.from_numpy((0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)).cuda()
s = rms_scale_batch(y)
for n in names:
    lib = ctypes.CDLL(f"_proof/libv_{n}.so")
    f = lib.mel_power_ct_split_launch
    f.argtypes = [vp, i64, vp, vp, vp, vp, vp, *[i32] * 10, vp]
    for exact, first, T in ((True, 0, 626), (False, 217, 192)):
        tab, win, wr = tk._tables(cfg, y.device, "ct_fused", exact)
        out = torch.empty(B, T, 64, device="cuda")
        for C, stages in ((1, 4), (1, 3), (1, 2), (2, 4), (4, 4)):
            def go():
                e = f(y.data_ptr(), y.shape[1], s.data_ptr(), tab.data_ptr(), win.data_ptr(), wr.data_ptr(), out.data_ptr(),
                      B, T, first, 1024, 2048, 384, 64, stages, C, int(not exact), torch.cuda.current_stream().cuda_stream)
                assert e == 0, e
            ms = cuda_ms(go, iters=3, warmup=1)
            print(f"[variant] {n} exact={exact} C={C} stages={stages}: {ms:.3f} ms", flush=True)
