"""Instrumented copy of the split kernel: cycles by phase, summed over blocks (thread 0 and the producer)."""
import ctypes, subprocess, sys, numpy as np, torch
sys.path.insert(0, ".")
from anuraxla_torch.constants import DEFAULT_MEL as cfg
from anuraxla_torch.ops import mel_kernel as tk
from anuraxla_torch.ops.frontend import rms_scale_batch
from anuraxla_torch.probes.common import cuda_ms

VARIANT = sys.argv[1] if len(sys.argv) > 1 else "cur"
STAGES = [int(v) for v in (sys.argv[2] if len(sys.argv) > 2 else "4").split(",")]
CLUSTERS = [int(v) for v in (sys.argv[3] if len(sys.argv) > 3 else "1").split(",")]
src = open("anuraxla_torch/csrc/mel_power_ct_split.cu").read().replace('#include "mel_', '#include "../anuraxla_torch/csrc/mel_')
subs = [
    ("__device__ __forceinline__ uint32_t next_stage(const Ctx& x) {", "__device__ __forceinline__ uint32_t next_stage(Ctx& x) {"),
    ("namespace {\n", "namespace {\n__device__ unsigned long long g_prof[16];\n"),
    ("  uint32_t phase;         // parity of that slot's fill\n",
     "  uint32_t phase;         // parity of that slot's fill\n  unsigned long long wcyc = 0, ocyc = 0, fcyc = 0, pcyc = 0, icyc = 0, ccyc = 0, rcyc = 0, tlast = 0;\n"),
    ("  mbar_wait(x.full + 8 * x.slot, x.phase);\n",
     "  const unsigned long long w0 = clock64();\n  mbar_wait(x.full + 8 * x.slot, x.phase);\n  x.wcyc += clock64() - w0;\n  x.tlast = clock64();\n"),
    ("    wgmma_wait<0>();\n    fence_operand(acc);\n    op.retire(acc);\n    release_stage(x);\n",
     "    wgmma_wait<0>();\n    fence_operand(acc);\n    const unsigned long long r0 = clock64(); x.ccyc += r0 - x.tlast;\n    op.retire(acc);\n    release_stage(x);\n    x.rcyc += clock64() - r0;\n"),
    ("  run_stages(x, outer, (has_im ? 2 : 1) * (EXACT ? 8 : 4));\n",
     "  unsigned long long c0 = clock64();\n  run_stages(x, outer, (has_im ? 2 : 1) * (EXACT ? 8 : 4));\n  x.ocyc += clock64() - c0; c0 = clock64();\n"),
    ("  fence_async_smem();\n  consumer_sync();\n\n  constexpr int PARTS",
     "  fence_async_smem();\n  consumer_sync();\n  x.pcyc += clock64() - c0; c0 = clock64();\n\n  constexpr int PARTS"),
    ("  run_stages(x, fb, 8 / ks_stage);\n", "  run_stages(x, fb, 8 / ks_stage);\n  x.fcyc += clock64() - c0;\n"),
    ("        inner_group16<0, TF>(r0, aud, p.hop, w, p.wr, n2, tsub, store);\n        fence_async_smem();\n        consumer_sync();\n",
     "        const unsigned long long i0 = clock64();\n        inner_group16<0, TF>(r0, aud, p.hop, w, p.wr, n2, tsub, store);\n        fence_async_smem();\n        consumer_sync();\n        x.icyc += clock64() - i0;\n"),
    ("  const int warp_id = __shfl_sync(0xffffffffu, tid >> 5, 0);", "  const unsigned long long T0 = clock64();\n  const int warp_id = __shfl_sync(0xffffffffu, tid >> 5, 0);"),
    ("  cluster_sync();  // every block's barriers exist before any copy or remote arrival\n",
     "  cluster_sync();  // every block's barriers exist before any copy or remote arrival\n  if (tid == 0) atomicAdd(&g_prof[1], clock64() - T0);\n"),
    ("        mbar_wait(full0 + 8 * (MAX_STAGES + slot), phase ^ 1);\n",
     "        const unsigned long long e0 = clock64();\n        mbar_wait(full0 + 8 * (MAX_STAGES + slot), phase ^ 1);\n        pe += clock64() - e0;\n"),
    ("      const uint16_t mask = (uint16_t)((1u << csize) - 1);\n",
     "      const uint16_t mask = (uint16_t)((1u << csize) - 1);\n      unsigned long long pe = 0; const unsigned long long P0 = clock64();\n"),
    ("          phase ^= 1;\n        }\n      }\n",
     "          phase ^= 1;\n        }\n      }\n      atomicAdd(&g_prof[9], pe); atomicAdd(&g_prof[10], clock64() - P0);\n"),
    ("    // the warpgroups' running mels meet in shared memory",
     "    if (tid == 0) { atomicAdd(&g_prof[2], x.wcyc); atomicAdd(&g_prof[3], x.ocyc); atomicAdd(&g_prof[4], x.pcyc);\n"
     "      atomicAdd(&g_prof[5], x.fcyc); atomicAdd(&g_prof[6], x.icyc); atomicAdd(&g_prof[7], clock64() - T0); atomicAdd(&g_prof[8], 1ull); atomicAdd(&g_prof[11], x.ccyc); atomicAdd(&g_prof[12], x.rcyc); }\n"
     "    // the warpgroups' running mels meet in shared memory"),
    ("  __syncwarp();\n  cluster_sync();  // no block leaves", "  if (tid == 0) atomicAdd(&g_prof[0], clock64() - T0);\n  __syncwarp();\n  cluster_sync();  // no block leaves"),
    ('extern "C" {\n', 'extern "C" {\nint get_prof(unsigned long long* h) { return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof)); }\n'
                     'int zero_prof() { unsigned long long z[16] = {0}; return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }\n'),
]
EXTRA = {
    "cur": [],
    "relaxed": [('asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\\n" ::"r"(bar) : "memory");',
                 'asm volatile("mbarrier.arrive.relaxed.cta.shared::cta.b64 _, [%0];\\n" ::"r"(bar) : "memory");')],
    "cpasync": [('    if (tid == NCONS) {\n      const uint32_t piece = STAGE_BYTES / csize;\n      const uint16_t mask = (uint16_t)((1u << csize) - 1);\n', '    if (tid >= 0) {\n      const int lane = tid & 31;\n      const uint32_t piece = STAGE_BYTES / csize;\n      const uint16_t mask = (uint16_t)((1u << csize) - 1);\n'), ('        mbar_expect_tx(full0 + 8 * slot, STAGE_BYTES);\n        bulk_copy(smem_u32(ring + slot * STAGE_BYTES + crank * piece),\n                  p.tab + (size_t)i * STAGE_BYTES + crank * piece, piece, full0 + 8 * slot, mask, csize > 1);\n', '        {\n          const uint32_t dst = smem_u32(ring + slot * STAGE_BYTES);\n          const uint8_t* src = p.tab + (size_t)i * STAGE_BYTES;\n#pragma unroll 8\n          for (int j = lane; j < STAGE_BYTES / 16; j += 32)\n            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(dst + 16 * j), "l"(src + 16 * j) : "memory");\n          asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\\n" ::"r"(full0 + 8 * slot) : "memory");\n        }\n'), ("      mbar_init(full0 + 8 * s, 1); ", "      mbar_init(full0 + 8 * s, 32);"),
                ("      atomicAdd(&g_prof[9], pe);", "      if (lane == 0) atomicAdd(&g_prof[9], pe); if (lane == 0)"),
                ("  x.wcyc += clock64() - w0;\n", "  x.wcyc += clock64() - w0;\n  fence_async_smem();\n")],
    "early": [('  op.issue(x, 0, a0);\n#pragma unroll 1\n  for (int s = 1; s < n; s += 2) {\n    op.issue(x, s, a1);\n    wgmma_wait<1>();\n    fence_operand(a0);\n    op.retire(a0);\n    release_stage(x);\n    if (s + 1 < n) {\n      op.issue(x, s + 1, a0);\n      wgmma_wait<1>();\n    } else {\n      wgmma_wait<0>();\n    }\n    fence_operand(a1);\n    op.retire(a1);\n    release_stage(x);\n  }\n  if (n & 1) {\n    wgmma_wait<0>();\n    fence_operand(a0);\n    op.retire(a0);\n    release_stage(x);\n  }', '#pragma unroll 1\n  for (int s = 0; s < n; ++s) {\n    op.issue(x, s, a0);\n    wgmma_wait<0>();\n    fence_operand(a0);\n    op.retire(a0);\n    release_stage(x);\n  }')],
    "split": [('        bulk_copy(smem_u32(ring + slot * STAGE_BYTES + crank * piece),\n                  p.tab + (size_t)i * STAGE_BYTES + crank * piece, piece, full0 + 8 * slot, mask, csize > 1);', '        for (int part = 0; part < 8; ++part)\n          bulk_copy(smem_u32(ring + slot * STAGE_BYTES + crank * piece + part * (piece / 8)),\n                    p.tab + (size_t)i * STAGE_BYTES + crank * piece + part * (piece / 8), piece / 8, full0 + 8 * slot, mask, csize > 1);')],
    "earlysplit": [('  op.issue(x, 0, a0);\n#pragma unroll 1\n  for (int s = 1; s < n; s += 2) {\n    op.issue(x, s, a1);\n    wgmma_wait<1>();\n    fence_operand(a0);\n    op.retire(a0);\n    release_stage(x);\n    if (s + 1 < n) {\n      op.issue(x, s + 1, a0);\n      wgmma_wait<1>();\n    } else {\n      wgmma_wait<0>();\n    }\n    fence_operand(a1);\n    op.retire(a1);\n    release_stage(x);\n  }\n  if (n & 1) {\n    wgmma_wait<0>();\n    fence_operand(a0);\n    op.retire(a0);\n    release_stage(x);\n  }', '#pragma unroll 1\n  for (int s = 0; s < n; ++s) {\n    op.issue(x, s, a0);\n    wgmma_wait<0>();\n    fence_operand(a0);\n    op.retire(a0);\n    release_stage(x);\n  }'), ('        bulk_copy(smem_u32(ring + slot * STAGE_BYTES + crank * piece),\n                  p.tab + (size_t)i * STAGE_BYTES + crank * piece, piece, full0 + 8 * slot, mask, csize > 1);', '        for (int part = 0; part < 8; ++part)\n          bulk_copy(smem_u32(ring + slot * STAGE_BYTES + crank * piece + part * (piece / 8)),\n                    p.tab + (size_t)i * STAGE_BYTES + crank * piece + part * (piece / 8), piece / 8, full0 + 8 * slot, mask, csize > 1);')],
    # no handshake at all: consumers never wait or release, the producer copies nothing (garbage output)
    "nostages": [("  const unsigned long long w0 = clock64();\n  mbar_wait(x.full + 8 * slot, (uint32_t)(x.issued / x.stages) & 1);",
                  "  const unsigned long long w0 = clock64();"),
                 ("  if (x.lane == 0) {\n    const uint32_t bar = x.full", "  if (x.lane < 0) {\n    const uint32_t bar = x.full"),
                 ("      for (int i = 0; i < p.n_stages; ++i) {", "      for (int i = 0; i < 0; ++i) {")],
    # one lane of each warp polls the full barrier
    "warppoll": [("  mbar_wait(x.full + 8 * slot, (uint32_t)(x.issued / x.stages) & 1);\n",
                  "  if (x.lane == 0) mbar_wait(x.full + 8 * slot, (uint32_t)(x.issued / x.stages) & 1);\n  __syncwarp();\n")],
    "clock": [("    if (globaltimer() - t0 > 4000000000ull) __trap();", "    if (clock64() - (long long)t0 > (1ll << 33)) __trap();"),
              ("  const uint64_t t0 = globaltimer();\n  while", "  const uint64_t t0 = clock64();\n  while")],
    "testwait": [("mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;", "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;"),
                 ("    if (globaltimer() - t0 > 4000000000ull) __trap();", "    if (clock64() - (long long)t0 > (1ll << 33)) __trap();"),
                 ("  const uint64_t t0 = globaltimer();\n  while", "  const uint64_t t0 = clock64();\n  while")],
    # one wgmma a stage instead of three (exact): is the products' execution the bound?
    "onemma": [("      wgmma_m64n32k16(acc, desc(tile + 8192), desc(plane), false);  // T_lo * a_hi\n"
                "      wgmma_m64n32k16(acc, desc(tile), desc(lo), false);            // T_hi * a_lo\n", "")],
    # 1 KB a stage copied instead of 16 KB: is the copy the bound?
    "halfcopy": [("        mbar_expect_tx(full0 + 8 * slot, STAGE_BYTES);", "        mbar_expect_tx(full0 + 8 * slot, 8192);"),
                  ("p.tab + (size_t)i * STAGE_BYTES + crank * piece, piece, full0", "p.tab + (size_t)i * STAGE_BYTES + crank * 8192 / csize, 8192 / csize, full0")],
    "smallcopy": [("        mbar_expect_tx(full0 + 8 * slot, STAGE_BYTES);", "        mbar_expect_tx(full0 + 8 * slot, 1024);"),
                  ("p.tab + (size_t)i * STAGE_BYTES + crank * piece, piece, full0", "p.tab + (size_t)i * STAGE_BYTES + crank * 1024 / csize, 1024 / csize, full0")],
    # no wait for the previous stage's products before the next: wait<0> after each (no pipeline)
    "nopipe": [("    op.issue(x, s, a1);\n    wgmma_wait<1>();", "    wgmma_wait<0>();\n    op.issue(x, s, a1);\n    wgmma_wait<1>();")],
}[VARIANT]
for a, b in subs + EXTRA:
    assert src.count(a) == 1, a
    src = src.replace(a, b)
open(f"_proof/prof_{VARIANT}.cu", "w").write(src)
r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", f"_proof/libprof_{VARIANT}.so", f"_proof/prof_{VARIANT}.cu"], capture_output=True, text=True)
print("prof nvcc rc", r.returncode, r.stderr[-1500:] if r.returncode else "", flush=True)
lib = ctypes.CDLL(f"_proof/libprof_{VARIANT}.so")
vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
f = lib.mel_power_ct_split_launch
f.argtypes = [vp, i64, vp, vp, vp, vp, vp, *[i32] * 10, vp]
B = 1024
rng = np.random.default_rng(0)
y = torch.from_numpy((0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)).cuda()
s = rms_scale_batch(y)
names = ["total", "to_cluster_sync", "wait_full", "outer_pipeline", "power", "fb_pipeline", "inner", "consumer_total",
         "ctas", "producer_wait_empty", "producer_total", "issue_to_done", "retire_release"]
for exact, first, T in ((True, 0, 626), (False, 217, 192)):
    tab, win, wr = tk._tables(cfg, y.device, "ct_fused", exact)
    out = torch.empty(B, T, 64, device="cuda")
    for C, st in [(c, n) for c in CLUSTERS for n in STAGES]:
        def go():
            e = f(y.data_ptr(), y.shape[1], s.data_ptr(), tab.data_ptr(), win.data_ptr(), wr.data_ptr(), out.data_ptr(),
                  B, T, first, 1024, 2048, 384, 64, st, C, int(not exact), torch.cuda.current_stream().cuda_stream)
            assert e == 0, e
        go(); torch.cuda.synchronize()
        lib.zero_prof()
        ms = cuda_ms(go, iters=1, warmup=0)
        h = (ctypes.c_ulonglong * 16)()
        lib.get_prof(h)
        n = h[8]
        print(f"[prof {VARIANT}] exact={exact} C={C} stages={st} {ms:.3f} ms, per block (kcycles): " +
              ", ".join(f"{nm} {h[i] / n / 1e3:.1f}" for i, nm in enumerate(names) if i != 8), flush=True)
