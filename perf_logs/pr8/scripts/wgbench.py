import ctypes, subprocess, torch
r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", "_proof/libwgbench.so", "_proof/wgbench.cu"], capture_output=True, text=True)
print("nvcc rc", r.returncode, r.stderr[-2000:] if r.returncode else "", flush=True)
lib = ctypes.CDLL("_proof/libwgbench.so")
lib.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
out = torch.empty(132 * 512, device="cuda"); cyc = torch.zeros(132, dtype=torch.int64, device="cuda")
iters = 4096
for flags in (0, 1, 2, 3, 4, 7):
    rc = lib.run(32, 3, flags << 4, iters, out.data_ptr(), cyc.data_ptr())
    c = cyc.float().mean().item() / iters
    print(f"[wgbench] m64n32k16 chain=3 flags={flags} (1 try_wait, 2 arrive, 4 fadd) rc={rc}: {c:.1f} cycles a stage", flush=True)
