"""Third card call: as second.py, with the halo form at stride 1 and 2
(phase planes) and the strip loads four in flight. Run from the
repository's root:
    python perf_logs/pr13/scripts/third.py
"""
import subprocess
import sys
import time
import traceback

sys.path.insert(0, ".")
import torch  # noqa: E402

from anuraxla_torch.ops import _build  # noqa: E402
from anuraxla_torch.ops import int8 as i8  # noqa: E402

print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
t0 = time.time()
_build.build(["int8_gemm"])
print("build s", round(time.time() - t0, 1))
print(_build.lib_path("int8_gemm").with_suffix(".log").read_text()[-6000:], flush=True)
dev = "cuda"
g = torch.Generator(device=dev).manual_seed(0)
SAME = ((0, 1), (0, 1))
P1 = ((1, 1), (1, 1))
CONVS = [(192, 64, 1, 32, 2, SAME), (96, 32, 32, 32, 1, P1), (96, 32, 32, 64, 2, SAME), (48, 16, 64, 64, 1, P1),
         (48, 16, 64, 128, 2, SAME), (24, 8, 128, 128, 1, P1), (24, 8, 128, 256, 2, SAME), (12, 4, 256, 256, 1, P1),
         (96, 32, 32, 64, 2, P1), (7, 9, 3, 12, 2, ((0, 1), (1, 1))), (10, 6, 16, 24, 1, P1), (9, 7, 16, 32, 1, P1),
         (13, 9, 32, 64, 2, ((1, 1), (0, 1))), (11, 7, 64, 32, 1, P1), (5, 3, 256, 128, 2, ((1, 1), (1, 1)))]
DENSE = [(12288, 512), (9, 5), (100, 40), (64, 32), (256, 256)]


def ops_f32(shape, B, ties):
    if len(shape) == 2:
        K, N = shape
        xs, w = (B, K), torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    else:
        H, W, cin, N = shape[:4]
        xs, w = (B, H, W, cin), torch.randint(-127, 128, (3, 3, cin, N), generator=g, device=dev, dtype=torch.int8)
    sx = torch.rand(B, generator=g, device=dev) * 0.05 + 1e-3
    sxb = sx.reshape(-1, *[1] * (len(xs) - 1))
    x = torch.randn(xs, generator=g, device=dev) * 40 * sxb  # |x| / sx up to ~200: clamps
    if ties:  # exact ties: (k + 0.5) * sx with sx a power of two
        sx = torch.full((B,), 2.0 ** -5, device=dev)
        k = torch.randint(-140, 140, xs, generator=g, device=dev).float()
        x = (k + 0.5) * 2.0 ** -5
    sw = torch.rand(N, generator=g, device=dev) * 0.01 + 1e-4
    return x, w, sx, sw, torch.randn(N, generator=g, device=dev)


def call(shape, ops, plain=False, raw=False, packed=None, halo=None):
    if len(shape) == 2:
        f = i8.int8_dense_plain if plain else i8.int8_dense
        return f(*ops, raw=raw) if plain else f(*ops, raw=raw, packed=packed)
    f = i8.int8_conv_plain if plain else i8.int8_conv
    return (f(*ops, shape[4], shape[5], raw=raw) if plain
            else f(*ops, shape[4], shape[5], raw=raw, packed=packed, halo=halo))


def halos(shape):
    if len(shape) == 2 or not i8.halo_fits(*shape[:4], shape[4], shape[5], i8.stage_depth(9 * shape[2])):
        return (None,)
    return (False, True)


bad = 0
for shape in CONVS + DENSE:
    for B in (1, 63, 1024) if shape in CONVS[:8] or shape == DENSE[0] else (1, 5):
        for ties in (False, True):
            try:
                ops = ops_f32(shape, B, ties)
                q = i8.quantize_rows(ops[0], ops[2])
                for mode, o in (("f32", ops), ("int8", (q,) + ops[1:])):
                    for raw in (False, True):
                        ref = call(shape, o, plain=True, raw=raw)
                        for halo in halos(shape):
                            got = call(shape, o, raw=raw, halo=halo)
                            torch.cuda.synchronize()
                            if not torch.equal(got, ref):
                                bad += 1
                                d = (got.double() - ref.double()).abs()
                                print("MISMATCH", shape, B, ties, mode, raw, halo, "max", d.max().item(), "n",
                                      int((d > 0).sum()), "first", (d > 0).nonzero()[:3].tolist(), flush=True)
            except Exception:
                bad += 1
                print("ERROR", shape, B, ties, traceback.format_exc()[-1500:], flush=True)
print("bitwise cases done; bad =", bad, flush=True)


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


tot = {}
for shape in CONVS[:8] + DENSE[:1]:
    ops = ops_f32(shape, 1024, False)
    pk = i8.pack_weight(ops[1]) if i8.wgmma_tile(ops[1].numel() // ops[1].shape[-1], ops[1].shape[-1],
                                                 dense=len(shape) == 2) else None
    q = i8.quantize_rows(ops[0], ops[2])
    for halo in halos(shape):
        t_i = ms(lambda: call(shape, (q,) + ops[1:], packed=pk, halo=halo))
        t_f = ms(lambda: call(shape, ops, packed=pk, halo=halo))
        t_r = ms(lambda: call(shape, (i8.quantize_rows(ops[0], ops[2]),) + ops[1:], packed=pk, halo=halo))
        for k, v in (("int8", t_i), ("f32", t_f), ("route", t_r)):
            tot[f"{k} halo={halo}"] = tot.get(f"{k} halo={halo}", 0.0) + v
        print(f"time {shape} B=1024 halo={halo}: int8 mode {t_i:.4f} ms, f32 mode {t_f:.4f} ms, torch quantize + "
              f"int8 mode {t_r:.4f} ms", flush=True)
print("sum", {k: round(v, 4) for k, v in tot.items()})
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                     text=True).stdout)
print("ALL OK" if bad == 0 else f"FAILED {bad}")
