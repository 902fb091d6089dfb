"""Per-stage timestamps in block 0: producer issue, consumer (warp 0) full observed, consumer release."""
import ctypes, subprocess, sys, numpy as np, torch
sys.path.insert(0, ".")
from anuraxla_torch.constants import DEFAULT_MEL as cfg
from anuraxla_torch.ops import mel_kernel as tk
from anuraxla_torch.ops.frontend import rms_scale_batch
src = open("anuraxla_torch/csrc/mel_power_ct_split.cu").read().replace('#include "mel_', '#include "../anuraxla_torch/csrc/mel_')
subs = [
    ("namespace {\n", "namespace {\n__device__ long long g_tr[4][512];\n__device__ long long g_w[2][16][256];\n"),
    ("  const int slot = x.issued % x.stages;\n", "  const int slot = x.issued % x.stages;\n"
     "  if (blockIdx.x == 0 && blockIdx.y == 0 && x.lane == 0 && x.issued < 256) g_w[0][threadIdx.x >> 5][x.issued] = clock64();\n"),
    ("  mbar_wait(x.full + 8 * slot, (uint32_t)(x.issued / x.stages) & 1);\n",
     "  mbar_wait(x.full + 8 * slot, (uint32_t)(x.issued / x.stages) & 1);\n"
     "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 && x.issued < 512) g_tr[1][x.issued] = clock64();\n"),
    ("  ++x.released;\n", "  if (blockIdx.x == 0 && blockIdx.y == 0 && x.lane == 0 && x.released < 256) g_w[1][threadIdx.x >> 5][x.released] = clock64();\n"
     "  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 && x.released < 512) g_tr[2][x.released] = clock64();\n  ++x.released;\n"),
    ("        mbar_wait(full0 + 8 * (MAX_STAGES + slot), ((uint32_t)(i / p.stages) & 1) ^ 1);\n",
     "        if (blockIdx.x == 0 && blockIdx.y == 0 && i < 512) g_tr[3][i] = clock64();\n"
     "        mbar_wait(full0 + 8 * (MAX_STAGES + slot), ((uint32_t)(i / p.stages) & 1) ^ 1);\n"),
    ("        mbar_expect_tx(full0 + 8 * slot, STAGE_BYTES);\n",
     "        if (blockIdx.x == 0 && blockIdx.y == 0 && i < 512) g_tr[0][i] = clock64();\n        mbar_expect_tx(full0 + 8 * slot, STAGE_BYTES);\n"),
    ('extern "C" {\n', 'extern "C" {\nint get_tr(long long* h) { return (int)cudaMemcpyFromSymbol(h, g_tr, sizeof(g_tr)); }\nint get_w(long long* h) { return (int)cudaMemcpyFromSymbol(h, g_w, sizeof(g_w)); }\n'),
]
for a, b in subs:
    assert src.count(a) == 1, a
    src = src.replace(a, b)
open("_proof/trace.cu", "w").write(src)
r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", "_proof/libtrace.so", "_proof/trace.cu"], capture_output=True, text=True)
print("trace nvcc rc", r.returncode, r.stderr[-1500:] if r.returncode else "", flush=True)
lib = ctypes.CDLL("_proof/libtrace.so")
vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
f = lib.mel_power_ct_split_launch
f.argtypes = [vp, i64, vp, vp, vp, vp, vp, *[i32] * 10, vp]
for B in (1024,):
    rng = np.random.default_rng(0)
    y = torch.from_numpy((0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)).cuda()
    s = rms_scale_batch(y)
    tab, win, wr = tk._tables(cfg, y.device, "ct_fused", True)
    out = torch.empty(B, 626, 64, device="cuda")
    for _ in range(2):
        e = f(y.data_ptr(), y.shape[1], s.data_ptr(), tab.data_ptr(), win.data_ptr(), wr.data_ptr(), out.data_ptr(),
              B, 626, 0, 1024, 2048, 384, 64, 4, 1, 0, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
    h = (ctypes.c_longlong * (4 * 512))(); lib.get_tr(h)
    tr = np.frombuffer(h, np.int64).reshape(4, 512)[:, :146].astype(np.float64)
    hw = (ctypes.c_longlong * (2 * 16 * 256))(); lib.get_w(hw)
    w = np.frombuffer(hw, np.int64).reshape(2, 16, 256)[:, :, :146].astype(np.float64)
    t0 = tr[0, 0]
    tr -= t0; w -= t0
    issue, full0, rel0, pwait = tr
    enter, relw = w  # per warp: entering next_stage (before the wait), release
    last_rel = relw.max(axis=0)
    print("[trace] per stage (cycles from the first issue): producer starts waiting | issues | warp0 enters | data seen by warp0 | "
          "first warp release | last warp release | spread of entries over warps", flush=True)
    for i in list(range(16, 40)):
        print(f"  {i:3d}: pw {pwait[i]:7.0f} is {issue[i]:7.0f} en {enter[0, i]:7.0f} full {full0[i]:7.0f} "
              f"rel {relw[:, i].min():7.0f}..{last_rel[i]:7.0f} enter-spread {enter[:, i].max() - enter[:, i].min():5.0f} "
              f"slowest-warp {int(relw[:, i].argmax())}", flush=True)
    print(f"[trace] medians: issue(i+4)-lastrel(i) {np.median(issue[4:] - last_rel[:-4]):.0f}, full-issue {np.median(full0 - issue):.0f}, "
          f"lastrel-firstrel {np.median(last_rel - relw.min(axis=0)):.0f}, period {np.median(np.diff(full0)):.0f}", flush=True)
