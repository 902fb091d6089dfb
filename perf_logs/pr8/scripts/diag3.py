import ctypes, subprocess, sys, torch
sys.path.insert(0, ".")
from anuraxla_torch.constants import DEFAULT_MEL as cfg
from anuraxla_torch.ops import mel_kernel as tk
so = "_proof/libdiag3.so"
r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", so, "_proof/probe3.cu"], capture_output=True, text=True)
print("diag3 nvcc rc", r.returncode, r.stderr[-1500:] if r.returncode else "", flush=True)
lib = ctypes.CDLL(so)
vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
lib.diag_launch.argtypes = [vp, i64, vp, vp, vp, vp] + [i32] * 8
y = torch.randn(1, cfg.num_samples, device="cuda") * 0.1
for bf16 in (1, 0):
    tab, win, wr = tk._tables(cfg, y.device, "ct_fused", not bf16)
    out = torch.empty(1, 64, 64, device="cuda")
    for stages, cluster, attr in ((4, 1, 1), (4, 1, 0), (2, 1, 1), (2, 1, 0)):
        rc = lib.diag_launch(y.data_ptr(), y.shape[1], tab.data_ptr(), win.data_ptr(), wr.data_ptr(), out.data_ptr(),
                             64, 2048, 384, 64, stages, cluster, bf16, attr)
        if rc not in (0, 1):
            sys.exit(rc)
