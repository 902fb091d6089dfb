"""Variants of csrc/int8_gemm.cu's halo and gathered kernels — more blocks an
SM, more strip loads in flight — made here by replacing lines of the
source, built with the repository's nvcc flags into anuraxla_torch/_build/,
and timed at the default encoder's layers (B = 1024, both operand modes, the
forms the wrapper picks) against the intact source in one process, in turns
(CUDA events). Run from the repository's root:
    python perf_logs/pr13/scripts/tune.py
"""
import ctypes
import subprocess
import sys

sys.path.insert(0, ".")
import torch  # noqa: E402

from anuraxla_torch.ops import _build  # noqa: E402
from anuraxla_torch.ops import int8 as i8  # noqa: E402

SRC = (_build.CSRC / "int8_gemm.cu").read_text()
LB = "__launch_bounds__(NTHREADS, BN <= 64 ? 3 : (BN == 128 ? 2 : 1))"
HALO = "int8_halo_kernel(const Params p)"
VARIANTS = {
    "intact": [],
    "halo_4_blocks": [(HALO, LB, "__launch_bounds__(NTHREADS, BN <= 32 ? 4 : (BN == 64 ? 3 : (BN == 128 ? 2 : 1)))")],
    "halo_8_loads": [(HALO, "e0 += 4 * step", "e0 += 8 * step"), (HALO, "float4 v[4];", "float4 v[8];"),
                     (HALO, "int4 v[4];", "int4 v[8];"), (HALO, "u < 4", "u < 8")],
    "gather_4_blocks": [("int8_wgmma_kernel(const Params p)", LB,
                         "__launch_bounds__(NTHREADS, BN <= 32 ? 4 : (BN == 64 ? 3 : (BN == 128 ? 2 : 1)))")],
}


def variant(edits):
    src = SRC
    for anchor, a, b in edits:
        # the edit applies to the kernel defined after `anchor`'s template line: find the
        # occurrence of `a` closest before (launch bounds) or after (body) the anchor
        k = src.index(anchor)
        if a == LB:
            j = src.rindex(a, 0, k)
            src = src[:j] + b + src[j + len(a):]
        else:
            end = src.index("\n}\n", k)
            body = src[k:end].replace(a, b)
            src = src[:k] + body + src[end:]
    return src


procs = []
_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
for name, edits in VARIANTS.items():
    path = _build.BUILD_DIR / f"int8_tune_{name}.cu"
    path.write_text(variant(edits))
    out = path.with_suffix(".so")
    procs.append((name, out, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(path)],
                                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
libs = {}
base = i8._lib()
for name, out, proc in procs:
    log, _ = proc.communicate()
    if proc.returncode:
        print(name, log[-3000:])
        raise SystemExit(1)
    print(name, "; ".join(ln.strip() for ln in log.splitlines() if "spill" in ln and " 0 bytes spill" not in ln)
          or "no spills", flush=True)
    lib = ctypes.CDLL(str(out))
    for fn in ("int8_conv_launch", "int8_dense_launch"):
        getattr(lib, fn).argtypes = getattr(base, fn).argtypes
        getattr(lib, fn).restype = getattr(base, fn).restype
    libs[name] = lib


def ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


g = torch.Generator(device="cuda").manual_seed(0)
SAME, P1 = ((0, 1), (0, 1)), ((1, 1), (1, 1))
LAYERS = [(96, 32, 32, 32, 1, P1), (96, 32, 32, 64, 2, SAME), (48, 16, 64, 64, 1, P1), (48, 16, 64, 128, 2, SAME),
          (24, 8, 128, 128, 1, P1), (24, 8, 128, 256, 2, SAME), (12, 4, 256, 256, 1, P1)]
total = {}
for shape in LAYERS:
    H, W, cin, cout, stride, pads = shape
    B = 1024
    x = torch.randn(B, H, W, cin, generator=g, device="cuda")
    sx = x.abs().amax(dim=(1, 2, 3)) / 127
    w = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, device="cuda", dtype=torch.int8)
    sw, bias = torch.rand(cout, device="cuda") * 0.01, torch.randn(cout, device="cuda")
    pk = i8.pack_weight(w)
    for mode, xin in (("f32", x), ("int8", i8.quantize_rows(x, sx))):
        ref = i8.int8_conv(xin, w, sx, sw, bias, stride, pads, packed=pk)
        row = {}
        for rep in range(2):
            for name, lib in (libs.items() if rep == 0 else reversed(list(libs.items()))):
                orig = i8._lib
                i8._lib = lambda lib=lib: lib
                try:
                    out = i8.int8_conv(xin, w, sx, sw, bias, stride, pads, packed=pk)
                    assert torch.equal(out, ref), name
                    t = ms(lambda: i8.int8_conv(xin, w, sx, sw, bias, stride, pads, packed=pk))
                finally:
                    i8._lib = orig
                row.setdefault(name, []).append(t)
                total[(mode, name)] = total.get((mode, name), 0.0) + t / 2
        print(f"tune {shape} B={B} {mode}: " + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in row.items()),
              flush=True)
for mode in ("f32", "int8"):
    print(f"tune sum of the 7 wgmma convs {mode}: " + ", ".join(f"{n} {total[(mode, n)]:.4f}" for n in libs), flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                     text=True).stdout)
