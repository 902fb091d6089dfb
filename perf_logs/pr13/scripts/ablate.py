"""Where the halo form's time goes: variants of csrc/int8_gemm.cu with one
class of work removed, made here by replacing lines of the source, built
with the repository's nvcc flags into anuraxla_torch/_build/ and timed
against the intact source in one process (CUDA events). Run from the
repository's root:
    python perf_logs/pr13/scripts/ablate.py
The variants compute wrong outputs; only their times mean anything.
"""
import ctypes
import subprocess
import sys

sys.path.insert(0, ".")
import torch  # noqa: E402

from anuraxla_torch.ops import _build  # noqa: E402
from anuraxla_torch.ops import int8 as i8  # noqa: E402

SRC = (_build.CSRC / "int8_gemm.cu").read_text()
HALO = SRC.index("int8_halo_kernel(const Params p)")
VARIANTS = {
    "intact": [],
    "no_strip_reads": [("so >= 0 ? __ldg(", "false ? __ldg(")],
    "no_quantize": [("src_row[e] >= 0 ? quant4(v[u], sc_row[e]) : 0u", "__float_as_uint(v[u].x)")],
    "no_products": [("      wgmma<BN>(acc, desc(a, hr * 16, 128), desc(w_addr + j * BN * 32), i | j);\n", "")],
    "no_output": [("    store4(p, m, 4 * q, a, sx_row[64 * wg + r]);", "")],
}
libs = {}
procs = []
for name, edits in VARIANTS.items():
    src = SRC[:HALO] + SRC[HALO:]
    head, tail = src[:HALO], src[HALO:]
    for a, b in edits:
        assert a in tail, (name, a)
        tail = tail.replace(a, b)
    path = _build.BUILD_DIR / f"int8_ablate_{name}.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(head + tail)
    out = path.with_suffix(".so")
    procs.append((name, out, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(path)],
                                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
for name, out, proc in procs:
    log, _ = proc.communicate()
    if proc.returncode:
        print(name, log[-3000:])
        raise SystemExit(1)
    libs[name] = ctypes.CDLL(str(out))
base = i8._lib()
for lib in libs.values():
    for fn in ("int8_conv_launch", "int8_dense_launch"):
        getattr(lib, fn).argtypes = getattr(base, fn).argtypes
        getattr(lib, fn).restype = getattr(base, fn).restype


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
for shape in [(96, 32, 32, 32, 1, P1), (96, 32, 32, 64, 2, SAME), (48, 16, 64, 64, 1, P1), (12, 4, 256, 256, 1, P1)]:
    H, W, cin, cout, stride, pads = shape
    B = 1024
    x = torch.randn(B, H, W, cin, generator=g, device="cuda")
    sx = x.abs().amax(dim=(1, 2, 3)) / 127
    w = torch.randint(-127, 128, (3, 3, cin, cout), generator=g, device="cuda", dtype=torch.int8)
    sw, bias = torch.rand(cout, device="cuda") * 0.01, torch.randn(cout, device="cuda")
    pk = i8.pack_weight(w)
    xq = i8.quantize_rows(x, sx)
    for mode, xin in (("f32", x), ("int8", xq)):
        row = []
        for rep in range(2):
            for name, lib in libs.items():
                orig = i8._lib
                i8._lib = lambda lib=lib: lib
                t = ms(lambda: i8.int8_conv(xin, w, sx, sw, bias, stride, pads, packed=pk, halo=True))
                i8._lib = orig
                row.append(f"{name} {t:.4f}")
        print(f"ablate {shape} B={B} {mode}: " + ", ".join(row), flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                     text=True).stdout)
