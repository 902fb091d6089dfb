"""First card call: build int8_gemm, hold both kernels to their plain versions bitwise."""
import sys, time, subprocess
sys.path.insert(0, ".")
import torch
print(sys.version, torch.__version__, torch.version.cuda, flush=True)
try:
    import yaml; print("yaml", yaml.__version__)
except Exception as e:
    print("no yaml:", e)
from anuraxla_torch.ops import _build, int8
t0 = time.time(); _build.build(["int8_gemm"]); print("build s", time.time() - t0)
print(_build.lib_path("int8_gemm").with_suffix(".log").read_text())
g = torch.Generator().manual_seed(0)
def rnd(*s): return torch.randint(-127, 128, s, generator=g, dtype=torch.int8)
ok = True
for (B, H, W, cin, cout, stride, pads) in [(3, 192, 64, 1, 32, 2, ((0, 1), (0, 1))), (1, 96, 32, 32, 32, 1, ((1, 1), (1, 1))),
                                           (5, 48, 16, 64, 128, 2, ((1, 1), (1, 1))), (63, 12, 4, 256, 256, 1, ((1, 1), (1, 1))),
                                           (2, 7, 5, 4, 12, 2, ((0, 1), (1, 1))), (4, 9, 9, 3, 5, 1, ((1, 1), (1, 1)))]:
    x, w = rnd(B, H, W, cin), rnd(3, 3, cin, cout)
    sx = torch.rand(B, generator=g) * 0.1 + 1e-3; sw = torch.rand(cout, generator=g) * 0.01; bias = torch.randn(cout, generator=g)
    ref = int8.int8_conv_plain(x, w, sx, sw, bias, stride, pads)
    refr = int8.int8_conv_plain(x, w, sx, sw, bias, stride, pads, raw=True)
    d = lambda t: t.cuda()
    got = int8.int8_conv(d(x), d(w), d(sx), d(sw), d(bias), stride, pads).cpu()
    gotr = int8.int8_conv(d(x), d(w), d(sx), d(sw), d(bias), stride, pads, raw=True).cpu()
    gp = int8.int8_conv_plain(d(x), d(w), d(sx), d(sw), d(bias), stride, pads).cpu()
    e = (torch.equal(got, ref), torch.equal(gotr, refr), torch.equal(gp, ref))
    ok &= all(e); print("conv", B, H, W, cin, cout, stride, pads, e, flush=True)
for (M, K, N) in [(1, 12288, 512), (63, 12288, 512), (1024, 12288, 512), (17, 9, 5), (33, 100, 40)]:
    x, w = rnd(M, K), rnd(K, N)
    sx = torch.rand(M, generator=g) * 0.1; sw = torch.rand(N, generator=g) * 0.01; bias = torch.randn(N, generator=g)
    ref = int8.int8_dense_plain(x, w, sx, sw, bias)
    got = int8.int8_dense(x.cuda(), w.cuda(), sx.cuda(), sw.cuda(), bias.cuda()).cpu()
    got1 = int8.int8_dense(x.cuda(), w.cuda(), sx[:1].cuda(), sw.cuda(), bias.cuda()).cpu()
    ref1 = int8.int8_dense_plain(x, w, sx[:1], sw, bias)
    e = (torch.equal(got, ref), torch.equal(got1, ref1)); ok &= all(e); print("dense", M, K, N, e, flush=True)
torch.cuda.synchronize()
print("launches", int8.launches(), "ALL OK" if ok else "MISMATCH")
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout)
