// Fused mel power with the outer stage as ONE deep product per r over bf16
// split operands, on Hopper's warpgroup tensor-core products (wgmma): PCM
// rows -> [B, T, n_mels] f32.
//
// Replaces the `fused_dots=True` variant of the TPU kernels in
// anuraxla/ops/pallas_frontend.py: `_ct_outer_stage_fused` (:513-564) with
// the host tables `_ct_tables_folded_cat` (:197-264), as `mel_power_pallas`
// (:904) reaches it through the phase kernel (:1148, `fused=` :1096-1119) and
// the stack kernel (:1291, `fused` :1209). It ports that arithmetic, not its
// blocks. The function is the one of mel_power_ct.cu (fused RMS scale and
// clip, window and f32 inner stage, through mel_stage.cuh and
// mel_ct_inner.cuh; any hop % 32, `frame0`, `pad_l`). The outer stage differs:
//
//   exact   each inner plane a is split hi = bf16(a), lo = bf16(a - hi);
//           x_re | x_im = [ar_hi ar_hi ar_lo (ai_hi ai_hi ai_lo)] @ RHS_r,
//           K = 384 for the real-only r (0 and R/2), 768 otherwise, with the
//           RHS row blocks (C_hi|-S_hi; C_lo|-S_lo; C_hi|-S_hi) and
//           (S_hi|C_hi; S_lo|C_lo; S_hi|C_hi): hi*hi + hi*lo + lo*hi, the
//           sign of x_im folded into the table; p = x_re^2 + x_im^2 in f32,
//           split again (p_lo = bf16(p - p_hi), formed in f32);
//           mel += [p_hi p_hi p_lo] @ (F_hi; F_lo; F_hi).
//   bf16    [bf16(a_re) bf16(a_im)] @ (C_hi|-S_hi; S_hi|C_hi), K = 128 / 256,
//           p rounded once, mel += bf16(p) @ F_hi.
// Every product is of two bf16 values and exact in f32; sums are f32.
//
// Design. One block owns one row and 32 frames:
//   - Each distinct table part once. The host (ops/mel_kernel.py,
//     `ct_fused_tables`) stores T_hi and T_lo (and F_hi, F_lo) of each r,
//     bitwise from `ct_tables_folded_cat`; the hi tile serves both segments
//     that read it (a_hi*T_hi and a_lo*T_hi). The cat table's third row
//     block, a copy of the first, is never read: a third fewer bytes.
//   - The table as one stream of stages, in the order the block consumes
//     them (for R = 16 the inner stage's groups: r = 0 4 8 1 5 2 6 3 7; else
//     r = 0 .. R/2): 16 KB in the exact mode (one k16 step of T_hi and T_lo
//     of [256 columns][K] in the wgmma core-matrix order), 32 KB in the bf16
//     mode (four k16 steps of T_hi). One producer warp copies them with TMA
//     bulk copies (cp.async.bulk, mbarrier completion) into a ring of 2-4
//     slots (4 x 16 KB exact, 3 x 32 KB bf16 at n_fft 2048 / hop 384); a
//     slot is refilled when the block's 16 consumer warps have released it.
//   - Products on wgmma from shared memory: 16 consumer warps are four
//     warpgroups. Outer stage: A = the table (M = 256 columns, x_re and x_im
//     of a bin 8 rows apart, so a thread's accumulators hold both parts of
//     its bins and the power forms in registers), B = the inner stage's bf16
//     planes (N = 32 frames, K = n2), warpgroup w the rows of bins 32w..;
//     m64n32k16, three passes a k16 step in the exact mode. Filterbank: A =
//     the filterbank (mels zero-padded to 64 or 128), B = the split power;
//     the k16 steps of a stage are dealt to the warpgroups, each keeps a
//     running mel, and the four meet in shared memory in a fixed order.
//   - Each stage's products are summed from zero (at most four deep; the
//     tensor cores' accumulator truncates, PERF.md §6) and added in
//     round-to-nearest f32; the slot is released as soon as they complete.
//
// What bounds it (PERF.md §6, measured on the card). Not the bytes: its
// least time is 0.410 ms (rows, tables and output at 3.35 TB/s; 0.108 ms for
// the bf16 mode over the fast tier's 192 frames), and it reaches 4.8 % of it.
// Not L2 either: the stream reads 49.0 GB a batch from L2 at B = 1024 (the
// first version of this file read 73.5 GB). A study that multicast each
// stage across a thread-block cluster of 2 and 4 blocks along the row axis
// halved and quartered those bytes (24.5, 12.2 GB) and made the kernel
// slower (10.5 -> 11.0 -> 12.1 ms, perf_logs/pr8/final_proof.log); the
// cluster code alone (remote arrivals in the stage loop, cluster barriers,
// padding rows) cost 10.2-10.4 -> 8.4-8.5 ms at clusters of one block
// (perf_logs/pr8/ab_nocluster2.log), so it is gone. Nor the tensor cores:
// m64n32k16 from shared memory would take a stage's 12 products in a few
// hundred cycles. What bounds it is the stage loop's instructions: 16 warps
// each issue ~50 a 16 KB stage (wait, descriptors, three products, their
// wait, 16 f32 adds, release). With a division by the ring's size in the
// loop, descriptors built from scratch and a `.release.cluster` arrival on
// the ring's barriers it took 17-25 ms; counters, descriptors advanced by
// adding offsets, and a plain arrival took it to 11.4. The bulk copies land
// ~2900 cycles after their issue; the ring hides that because each slot is
// released as soon as its products complete. The inner stage's stores hit
// 4-way bank conflicts on core-matrix planes: padding the planes' strides
// (144 B along K, 288 B between 8-frame groups, 1184 B between k16 steps;
// the B descriptor takes any multiple of 16 B) took 11.4 to 10.2-10.5 ms.
// The bf16 mode's 16 KB stages carried two products a warpgroup; 32 KB
// stages took it from ~2.05 to 1.74-1.79 ms.
//
// Shared memory at n_fft 2048 / hop 384: exact, the ring (4 x 16 KB), eight
// mbarriers, the f32 window (55.8 KB), four hi and four lo planes and the
// split power (10 x 9472 B), 216 128 B; bf16, 3 x 32 KB and five planes,
// 201 536 B. One block of 544 threads an SM. The host's copy of this size
// and of the tile (32 frames, the deepest ring that fits) is
// ops/mel_kernel.py `ct_fused_smem_bytes`, `ct_fused_tile`.
//
// ptxas (nvcc 12.9, sm_90a), as ops/_build.py keeps it beside the library:
// 80 registers in both modes, 2 barriers, 0 bytes stack frame, 0 bytes spill
// stores, 0 bytes spill loads.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W, B = 1024, CUDA events
// (perf_logs/pr8/scripts/ab_nocluster.py, ab_nocluster2.log; beside it the
// source with the cluster path, launched in clusters of one block, in the
// same call): exact over 626 frames 8.529 / 8.481 ms (with the cluster path
// 10.396 / 10.239; the first version 11.475 / 11.399 by chip_smoke.py,
// final_proof.log; one torch.stft call 17.615), 270 TFLOP/s of its own form
// (2.300 TFLOP); the bf16 mode over the fast tier's 192 frames 1.519 / 1.519
// ms (1.728 / 1.724; the first version 1.842 / 1.841). chip_smoke.py's times
// of the final tree: PERF.md §6.
//
// A wait on an mbarrier that has not completed after 60 s traps instead of
// hanging the card: a fault in the stream's bookkeeping shows as an error,
// not as a hang. A trap is fatal to the process's CUDA context (every later
// call on the card fails), so the limit is far above any wait of a sound
// run, a kernel preempted or time-sliced with another context included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mel_ct_inner.cuh"
#include "mel_stage.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TF = 32;                 // frames per block: N of every product
constexpr int NCONS = 512;             // consumer threads: 4 warpgroups
constexpr int NTHREADS = NCONS + 32;   // and one producer warp
constexpr int NB = CT_NB;              // CT block length (n2 and q range)
// The planes (the B operand: [TF frames][NB] bf16, K-major core matrices).
// Their strides are padded so that the 16-byte rows a warp's 32 lanes (32
// consecutive n2 of one frame) write in the inner stage fall on distinct
// banks: 8-column halves 144 B apart (the leading byte offset), 8-frame
// groups 288 B (the stride byte offset), k16 steps 1184 B.
constexpr int PL_LBO = 144, PL_SBO = 288, PL_STEP = 1184;
constexpr int PLANE = NB / 16 * PL_STEP / 2;  // bf16 per plane (9472 B)
// One stage of the table stream: 16 KB in the exact mode (a k16 step of T_hi
// and T_lo), 32 KB in the bf16 mode (four k16 steps of T_hi: a stage of two
// products carried too little work for its bookkeeping).
template <bool EXACT>
__host__ __device__ constexpr int stage_bytes() { return EXACT ? 16384 : 32768; }
constexpr int MAX_STAGES = 4;          // ring slots at most

struct Params {
  const float* y;        // [B, L] rows
  const float* scale;    // [B] or nullptr
  const float* win;      // [n_fft] periodic Hann
  const float* wr;       // [R, 2] (cos, sin) of 2*pi*j/R
  const uint8_t* tab;    // [n_stages, stage_bytes] the table stream (ct_fused_tables)
  float* out;            // [B, T, n_mels]
  long long L;
  int B, T, n_fft, hop, n_mels, R;
  int frame0;    // first frame computed; out[:, t] is frame frame0 + t
  int pad_l;     // zeros before the row in the centre-padded signal
  int stages;    // ring slots
  int n_stages;  // stages of the stream
  int m_tiles;   // 64-row mel tiles of the filterbank product (1 or 2)
};

// ---- barriers, copies and products (PTX) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of `parity` has completed; trap after 60 s.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try(bar, parity))
    if (globaltimer() - t0 > 60000000000ull) __trap();
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// `bytes` from global memory to `dst`, completing on the barrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The 512 consumer threads (the producer warp is not held).
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory"); }

// Plain stores to shared memory made visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Operand descriptors: no swizzle, K-major, 8-row x 16-byte core matrices
// `lbo` bytes apart along K and `sbo` bytes apart along M (or N): 128 / 256
// for the tables as the host lays them out, PL_LBO / PL_SBO for the planes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo = 128, uint32_t sbo = 256) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ uint64_t desc_plane(uint32_t addr) { return desc(addr, PL_LBO, PL_SBO); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Wait until every committed group of this warpgroup has completed.
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Keep the compiler from moving accesses of `d` across a wgmma wait.
__device__ __forceinline__ void fence_operand(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 32, f32) = A (64 x 16) * B (16 x 32) [+ D unless `zero`], bf16
// operands from shared memory. Thread lane 4g + c of warp v of the
// warpgroup holds rows 16v + g (d[4j], d[4j+1]) and 16v + g + 8 (d[4j+2],
// d[4j+3]) at columns 8j + 2c, 8j + 2c + 1.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db, bool zero) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"((uint32_t)zero)
      : "memory");
}

// ---- the consumers' state and stages ----

// Where element (t, k) of a [TF][NB] plane lies (bf16 units): k16 step k/16,
// then 8-frame group, then 8-column half, then the core matrix (PL_*).
__device__ __forceinline__ int plane_off(int t, int k) {
  return ((k >> 4) * PL_STEP + (t >> 3) * PL_SBO + ((k >> 3) & 1) * PL_LBO) / 2 + (t & 7) * 8 + (k & 7);
}

struct Ctx {
  uint32_t ring;   // shared address of slot 0
  int sbytes;      // bytes a stage
  uint32_t full;   // shared address of full[0]; empty[s] = full + 8 (MAX_STAGES + s)
  int stages;
  int wg, warp, lane;     // warpgroup, warp in it, lane
  int slot;               // ring slot of the stage waited for next
  uint32_t phase;         // parity of that slot's fill
};

// Wait for the next stage of the stream; its shared address.
__device__ __forceinline__ uint32_t next_stage(const Ctx& x) {
  mbar_wait(x.full + 8 * x.slot, x.phase);
  return x.ring + x.slot * x.sbytes;
}

// This warp is done with the stage it waited for last: one arrival on its
// slot's `empty` barrier; then the next slot. (Counters, not a division by
// the ring's size: the stage loop is bound by the instructions its 16 warps
// issue, PERF.md.)
__device__ __forceinline__ void release_stage(Ctx& x) {
  if (x.lane == 0) mbar_arrive(x.full + 8 * (MAX_STAGES + x.slot));
  if (++x.slot == x.stages) {
    x.slot = 0;
    x.phase ^= 1;
  }
}

// Run the `n` stages of `op`: wait for a stage's data, issue its products
// (summed from zero on the tensor cores, at most four deep), wait for them,
// add them in round-to-nearest f32 and release the slot at once. A slot held
// past its products (until the next stage's data has arrived, as a two-deep
// pipeline of products holds it) delays its refill by the copy's latency,
// some 2900 cycles for a 16 KB bulk copy on an H100 (PERF.md).
template <class Op>
__device__ __forceinline__ void run_stages(Ctx& x, Op& op, int n) {
  float acc[16];
#pragma unroll 1
  for (int s = 0; s < n; ++s) {
    op.issue(x, s, acc);
    wgmma_wait();
    fence_operand(acc);
    op.retire(acc);
    release_stage(x);
  }
}

// The outer product of one r: stage s is k16 step(s) st of component
// s / steps (a_re, then a_im), against this warpgroup's 64 rows of the
// table. Exact: T_hi*a_hi + T_lo*a_hi + T_hi*a_lo; bf16: two k16 steps.
template <bool EXACT>
struct OuterOp {
  static constexpr int KS = EXACT ? 1 : 4;  // k16 steps a stage
  static constexpr int STEPS = 8 / KS;      // stages a component
  uint32_t a_hi;  // shared address of the a_re hi plane; a_im's is the next plane, lo 4 planes on
  float (&sum)[16];
  __device__ __forceinline__ void issue(Ctx& x, int s, float (&acc)[16]) {
    const uint32_t tile = next_stage(x) + x.wg * 2048;
    const uint32_t plane = a_hi + (s / STEPS) * PLANE * 2 + (s % STEPS) * KS * PL_STEP;
    const uint64_t da = desc(tile), db = desc_plane(plane);  // desc(a + d) = desc(a) + d / 16
    fence_operand(acc);
    wgmma_fence();
    if (EXACT) {
      wgmma_m64n32k16(acc, da, db, true);                            // T_hi * a_hi
      wgmma_m64n32k16(acc, da + 8192 / 16, db, false);               // T_lo * a_hi
      wgmma_m64n32k16(acc, da, db + 4 * PLANE * 2 / 16, false);      // T_hi * a_lo
    } else {
#pragma unroll
      for (int k = 0; k < KS; ++k) wgmma_m64n32k16(acc, da + k * (8192 / 16), db + k * (PL_STEP / 16), k == 0);
    }
    wgmma_commit();
  }
  __device__ __forceinline__ void retire(const float (&acc)[16]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
  }
};

// The filterbank product of one r: mel += [p_hi p_hi p_lo] @ FBCAT_r. The
// k16 steps of each stage are dealt to the warpgroups (warpgroup w: mel tile
// w % m_tiles, every (4 / m_tiles)-th step): one step a stage in the exact
// mode (its three passes), two in the bf16 mode (a stage holds a whole r's,
// zero-padded to the stage). Each warpgroup keeps its own running mel.
template <bool EXACT>
struct FbOp {
  uint32_t p_hi;  // shared address of the power's hi plane; lo follows
  int rows, ks_stage, kgroups, mt, kg;
  float (&mel)[16];
  __device__ __forceinline__ void issue(Ctx& x, int s, float (&acc)[16]) {
    const uint32_t base = next_stage(x) + mt * 2048;
    const uint32_t step = rows * 32;  // bytes of one k16 step of one part
    fence_operand(acc);
    wgmma_fence();
    if (EXACT) {
      const uint64_t da = desc(base + kg * step), db = desc_plane(p_hi + (s * ks_stage + kg) * PL_STEP);
      wgmma_m64n32k16(acc, da, db, true);                                  // F_hi * p_hi
      wgmma_m64n32k16(acc, da + ks_stage * step / 16, db, false);          // F_lo * p_hi
      wgmma_m64n32k16(acc, da, db + PLANE * 2 / 16, false);                // F_hi * p_lo
    } else {
#pragma unroll 1
      for (int ks = kg; ks < ks_stage; ks += kgroups)
        wgmma_m64n32k16(acc, desc(base + ks * step), desc_plane(p_hi + (s * ks_stage + ks) * PL_STEP), ks == kg);
    }
    wgmma_commit();
  }
  __device__ __forceinline__ void retire(const float (&acc)[16]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) mel[i] = __fadd_rn(mel[i], acc[i]);
  }
};

// Where the inner stage leaves plane k of its group at frame t: split into
// bf16 hi (planes 0-3) and, exact, lo (planes 4-7), in core-matrix order.
template <bool EXACT>
struct SplitStore {
  bf16* planes;
  int koff;  // plane_off's part of this thread's n2
  __device__ __forceinline__ void operator()(int k, int t, float v) const {
    const int o = k * PLANE + koff + (t >> 3) * (PL_SBO / 2) + (t & 7) * 8;
    const bf16 h = __float2bfloat16_rn(v);
    planes[o] = h;
    if (EXACT) planes[4 * PLANE + o] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
};

// One r: the outer product over its stages, the power, split, to `pw`
// ([TF][NB] hi, then lo), then the filterbank product. `a` is the a_re hi
// plane; a_im, where r has one, is the next plane.
template <bool EXACT>
__device__ __forceinline__ void do_r(Ctx& x, int m_tiles, const bf16* a, bool has_im, bf16* pw,
                                     float (&mel)[16]) {
  float sum[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) sum[i] = 0.f;
  OuterOp<EXACT> outer{smem_u32(a), sum};
  run_stages(x, outer, (has_im ? 2 : 1) * OuterOp<EXACT>::STEPS);

  // row g of the thread's warp is x_re of bin q, row g + 8 its x_im
  consumer_sync();  // every warpgroup is done with the previous r's power planes
  const int g = x.lane >> 2, c = x.lane & 3;
  const int q = 32 * x.wg + 8 * x.warp + g;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float xr = sum[4 * j + e], xi = sum[4 * j + 2 + e];
      const float pv = xr * xr + xi * xi;
      const int o = plane_off(8 * j + 2 * c + e, q);
      const bf16 h = __float2bfloat16_rn(pv);
      pw[o] = h;
      if (EXACT) pw[PLANE + o] = __float2bfloat16_rn(pv - __bfloat162float(h));  // lo formed in f32
    }
  fence_async_smem();
  consumer_sync();

  constexpr int PARTS = EXACT ? 2 : 1;
  const int rows = 64 * m_tiles;
  const int ks_stage = min(8, stage_bytes<EXACT>() / (PARTS * rows * 32));  // k16 steps a stage
  FbOp<EXACT> fb{smem_u32(pw), rows, ks_stage, 4 / m_tiles, x.wg % m_tiles, x.wg / m_tiles, mel};
  run_stages(x, fb, 8 / ks_stage);
}

template <bool EXACT>
__global__ void __launch_bounds__(NTHREADS, 1)
mel_power_ct_split_kernel(const Params p) {
  constexpr int PARTS = EXACT ? 2 : 1;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;
  constexpr int SB = stage_bytes<EXACT>();
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + p.stages * SB);  // full, then empty
  float* aud = reinterpret_cast<float*>(bars + 2 * MAX_STAGES);  // [n_aud] scaled, clipped samples
  const int n_aud = (TF - 1) * p.hop + p.n_fft;
  bf16* planes = reinterpret_cast<bf16*>(aud + ((n_aud + 3) & ~3));  // 4 hi planes, then 4 lo (exact)
  bf16* pw = planes + 4 * PARTS * PLANE;                              // the split power: hi, then lo

  const int tid = threadIdx.x;
  const int warp_id = __shfl_sync(0xffffffffu, tid >> 5, 0);  // warp-uniform, for the roles and wgmma
  const int b = blockIdx.y;
  const int t_base = blockIdx.x * TF;
  const uint32_t full0 = smem_u32(bars);

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);                      // the producer's expect_tx
      mbar_init(full0 + 8 * (MAX_STAGES + s), NCONS / 32);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");  // visible to the bulk copies
  }
  // the window and the inner stage run in f32 in both modes
  stage_audio(aud, n_aud, p.y + (long long)b * p.L, p.L, (long long)(p.frame0 + t_base) * p.hop, p.pad_l,
              p.scale != nullptr ? p.scale[b] : -1.f);
  __syncthreads();  // the barriers exist before any copy or arrival

  if (warp_id >= NCONS / 32) {
    // the producer: lane 0 streams the table, each stage as soon as its slot
    // is free
    if (tid == NCONS) {
      int slot = 0;
      uint32_t phase = 0;  // parity of the slot's fill; its `empty` phase to wait for is the other
      for (int i = 0; i < p.n_stages; ++i) {
        mbar_wait(full0 + 8 * (MAX_STAGES + slot), phase ^ 1);
        mbar_expect_tx(full0 + 8 * slot, SB);
        bulk_copy(smem_u32(ring + slot * SB), p.tab + (size_t)i * SB, SB, full0 + 8 * slot);
        if (++slot == p.stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    __syncwarp();
  } else {
    Ctx x{smem_u32(ring), SB, full0, p.stages, warp_id >> 2, warp_id & 3, tid & 31, 0, 0u};
    float mel[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) mel[i] = 0.f;

    const int n2 = tid % NB;
    const int tsub = tid / NB;
    const int R = p.R;
    const SplitStore<EXACT> store{planes, plane_off(0, n2)};
    const int mtl = p.m_tiles;

    if (R == 16) {
      // groups by r0 = r mod 4: {0, 4, 8}, {1, 5}, {2, 6}, {3, 7}, the
      // stream's order
#pragma unroll
      for (int r0 = 0; r0 < 4; ++r0) {
        float w[16];  // loaded for each group: not live across the products
#pragma unroll
        for (int n1 = 0; n1 < 16; ++n1) w[n1] = __ldg(p.win + n1 * NB + n2);
        inner_group16<0, TF>(r0, aud, p.hop, w, p.wr, n2, tsub, store);
        fence_async_smem();
        consumer_sync();
        if (r0 == 0) {
          do_r<EXACT>(x, mtl, planes, false, pw, mel);              // r = 0
          do_r<EXACT>(x, mtl, planes + PLANE, true, pw, mel);       // r = 4
          do_r<EXACT>(x, mtl, planes + 3 * PLANE, false, pw, mel);  // r = 8
        } else {
          do_r<EXACT>(x, mtl, planes, true, pw, mel);               // r = r0
          do_r<EXACT>(x, mtl, planes + 2 * PLANE, true, pw, mel);   // r = r0 + 4
        }
      }
    } else {
      // literal-weight R-point DFT, one r at a time
      for (int r = 0; r <= R / 2; ++r) {
        inner_generic<0, TF>(aud, p.hop, p.win, p.wr, R, r, n2, tsub, store);
        fence_async_smem();
        consumer_sync();
        do_r<EXACT>(x, mtl, planes, !(r == 0 || 2 * r == R), pw, mel);
      }
    }

    // the warpgroups' running mels meet in shared memory (over the planes,
    // which every product is done with), added in a fixed order
    consumer_sync();
    float* red = reinterpret_cast<float*>(planes);  // [4 warpgroups][64 rows][TF]
    {
      const int g = x.lane >> 2, c = x.lane & 3;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            red[(x.wg * 64 + 16 * x.warp + g + 8 * h) * TF + 8 * j + 2 * c + e] = mel[4 * j + 2 * h + e];
    }
    consumer_sync();
    for (int i = tid; i < TF * p.n_mels; i += NCONS) {
      const int t = i / p.n_mels, m = i % p.n_mels;
      if (t_base + t >= p.T) break;
      const int o = (m & 63) * TF + t;
      const float v = mtl == 1 ? ((red[o] + red[64 * TF + o]) + red[128 * TF + o]) + red[192 * TF + o]
                               : red[(m >> 6) * 64 * TF + o] + red[((m >> 6) + 2) * 64 * TF + o];
      p.out[((long long)b * p.T + t_base + t) * p.n_mels + m] = v;
    }
  }
}

int n_stages_of(int R, int n_mels, bool exact) {
  const int m_tiles = (n_mels + 63) / 64;
  const int outer = exact ? 8 : 2;                               // stages a component
  const int sb = exact ? stage_bytes<true>() : stage_bytes<false>();
  const int steps = sb / ((exact ? 2 : 1) * 64 * m_tiles * 32);
  const int fb = 8 / (steps < 8 ? steps : 8);  // stages a filterbank block
  int n = 0;
  for (int r = 0; r <= R / 2; ++r) n += ((r == 0 || 2 * r == R) ? 1 : 2) * outer + fb;
  return n;
}

}  // namespace

extern "C" {

// Shared memory (bytes) of the kernel with `stages` ring slots.
long long mel_power_ct_split_smem_bytes(int n_fft, int hop, int stages, int bf16_mode) {
  const long long n_aud = (long long)(TF - 1) * hop + n_fft;
  const int parts = bf16_mode ? 1 : 2;
  return (long long)stages * (bf16_mode ? stage_bytes<false>() : stage_bytes<true>()) + 16LL * MAX_STAGES + ((n_aud + 3) & ~3LL) * 4 +
         5LL * parts * PLANE * (long long)sizeof(bf16);
}

// Stages of the table stream for (n_fft, n_mels) and the mode.
int mel_power_ct_split_n_stages(int n_fft, int n_mels, int bf16_mode) {
  return n_stages_of(n_fft / NB, n_mels, !bf16_mode);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `tab` is the mode's table stream, as ops/mel_kernel.py `ct_fused_tables`
// builds it.
int mel_power_ct_split_launch(const float* y, long long L, const float* scale, const void* tab,
                              const float* win, const float* wr, float* out, int B, int T, int frame0,
                              int pad_l, int n_fft, int hop, int n_mels, int stages, int bf16_mode,
                              void* stream) {
  if (n_fft % NB != 0 || n_fft < 2 * NB || n_mels < 1 || n_mels > 128 || B < 1 || T < 1 || B > 65535 ||
      hop < 1 || frame0 < 0 || pad_l < 0 || stages < 2 || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.y = y; p.scale = scale; p.win = win; p.wr = wr;
  p.tab = static_cast<const uint8_t*>(tab);
  p.out = out; p.L = L; p.B = B; p.T = T; p.n_fft = n_fft; p.hop = hop;
  p.n_mels = n_mels; p.R = n_fft / NB; p.frame0 = frame0; p.pad_l = pad_l;
  p.stages = stages;
  p.n_stages = n_stages_of(p.R, n_mels, !bf16_mode);
  p.m_tiles = (n_mels + 63) / 64;
  const long long smem = mel_power_ct_split_smem_bytes(n_fft, hop, stages, bf16_mode);
  auto kernel = bf16_mode ? mel_power_ct_split_kernel<false> : mel_power_ct_split_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((T + TF - 1) / TF, B), NTHREADS, (size_t)smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
