"""Chip probe: wgmma descriptor semantics (which of LBO/SBO is the K stride)."""
import ctypes, subprocess, sys, numpy as np, torch
sys.path.insert(0, ".")
from anuraxla_torch.ops.mel_kernel import _core_matrices
so = "_proof/libprobe.so"
r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", so, "_proof/probe.cu"], capture_output=True, text=True)
print("probe nvcc rc", r.returncode, r.stdout[-2000:], r.stderr[-2000:], flush=True)
lib = ctypes.CDLL(so)
lib.run_wgmma.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
rng = np.random.default_rng(0)
A = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32)).to(torch.bfloat16)
Bm = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32)).to(torch.bfloat16)
want = A.double() @ Bm.double().T
a = _core_matrices(A).contiguous().view(torch.int16).cuda(); b = _core_matrices(Bm).contiguous().view(torch.int16).cuda()
for lbo, sbo in ((128, 256), (256, 128)):
    d = torch.zeros(64 * 32, device="cuda")
    rc = lib.run_wgmma(a.data_ptr(), b.data_ptr(), d.data_ptr(), lbo, sbo)
    err = (d.view(64, 32).double().cpu() - want).abs().max().item()
    print(f"[probe] wgmma lbo={lbo} sbo={sbo} rc={rc} max_err={err:.3e}", flush=True)
