import ctypes, subprocess, sys
sys.path.insert(0, ".")
from anuraxla_torch.ops import mel_kernel as tk
so = "_proof/libdiag.so"
r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", so, "_proof/probe2.cu"], capture_output=True, text=True)
print("diag nvcc rc", r.returncode, r.stderr[-1500:] if r.returncode else "", flush=True)
lib = ctypes.CDLL(so)
for bf16 in (0, 1):
    for stages in (4, 3, 2):
        smem = tk.ct_fused_smem_bytes(2048, 384, stages, not bf16)
        lib.diag(bf16, smem, 1)
