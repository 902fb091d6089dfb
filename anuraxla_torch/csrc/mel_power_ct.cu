// Fused Cooley-Tukey mel power on Hopper's tensor cores: PCM rows ->
// [B, T, n_mels] f32.
//
// Replaces three TPU kernels of anuraxla/ops/pallas_frontend.py, which
// compute one function and differ in how Mosaic lets them assemble frames:
//   - `_mel_power_ctp_kernel` (:567), exact mode, hop % 128 == 0, as
//     `mel_power_pallas` drives it from its phase branch (:1030-1172), with
//     the outer stage `_ct_outer_stage` (:402-492);
//   - the same kernel with exact=False (`_ct_outer_stage` :493-508): one
//     bf16 pass per product (EXACT = false below);
//   - `_mel_power_ct_kernel` (:739), the stack-assembled kernel for
//     hop % 32 == 0: its lane-phase copies, 5-D row views and
//     tile_t*hop % 8192 rule answer Mosaic's alignment and have no
//     counterpart here, where a frame is read at any sample offset.
// It ports what those kernels compute, not their blocking:
//
//   mel[b, t, :] = sum_k |DFT_n(hann[n] * v[b, (t0+t)*hop + n])[k]|^2 * fb[k, :]
//   v = clip(y * s, -1, 1) if s > 0 else y     (fused RMS normalization)
//
// over the centre-padded signal (n_fft/2 zeros before the row unless the row
// is pre-padded), for frames t0 .. t0+T-1, with the Cooley-Tukey split
// n = n1*128 + n2 (n1 < R = n_fft/128) and k = q*R + r. Per frame:
//   inner stage  A_r[n2] = sum_n1 x[n1*128 + n2] * W_R^(n1*r), only r <= R/2
//                (radix 4x4 for R = 16, a literal-weight sum for other R;
//                f32, mel_ct_inner.cuh);
//   outer stage  X_r[q] = A_r @ (C_r - i S_r) against the twiddle-folded
//                tables C/S (cos/sin of 2*pi*n2*(q*R + r)/n_fft);
//   power + mel  mel += |X_r|^2 @ FBM_r, FBM the merged filterbank that
//                folds the conjugate partner block R - r into block r.
//
// Arithmetic: the reference's own. Every product of the outer stage and of
// the filterbank is of two bf16 values on mma.sync.m16n8k16 with f32
// accumulators.
//   exact   the planes a_re / a_im are split hi = bf16(a), lo = bf16(a - hi)
//           (formed in f32, as `_split_bf16` :395), the tables likewise on
//           the host; each product is hi*hi + hi*lo + lo*hi (`dot3h` :443);
//           p = x_re^2 + x_im^2 in f32, split again;
//           mel += p_hi*F_hi + p_hi*F_lo + p_lo*F_hi.
//   bf16    bf16(a) against the bf16 tables, bf16(p) against bf16(FBM).
// The tensor cores' accumulator truncates at every mma, so no chain is long:
// x_re | x_im are summed on them over one ring buffer of k16 steps (at most
// 12 mma deep) from zero and the buffers added in round-to-nearest f32; each
// r's filterbank product is summed from zero (12 deep) and added to the
// running mel in f32. ops/mel_kernel.py `mel_power_ct_split_plain` is this
// arithmetic in PyTorch (held to the JAX kernel within 2e-5 of a row's max on
// the CPU); `ct_split_fragment_tables` lays the tables out.
//
// Design. One block of 8 warps owns one row and TF frames (64, else 32 or 16:
// the host picks the largest whose shared memory fits, `ct_tile`). The tile's
// audio window ((TF-1)*hop + n_fft samples) is staged in f32 once by cp.async,
// then scaled and clipped in place. For each r the inner stage writes the bf16 planes
// of that r alone (hi and, exact, lo; rows LDA = 136 apart, so an ldmatrix
// phase touches 32 distinct banks); for R = 16 the radix-4x4 group is
// computed once for each of its r (the inner stage is ~0.1 % of the time)
// so that only two planes are live and 64 frames fit beside the window.
// Warp w owns frame tile w % (TF/16) and the n8 groups of one q part
// (G = TF/8 groups of 8 bins); its A fragments come from the planes by
// ldmatrix. The tables' B fragments stream through a 3-deep cp.async ring,
// one r after another (128 KB a r in the exact mode, C and S hi/lo each once,
// read from L2 once per block for all its frames). One 16-byte load a lane
// holds C's and S's words of the same bins, and the same fragments serve a_re
// (x_re += a*C, x_im' += a*S) and a_im (x_re += a*S, x_im' += (-a)*C, the sign
// of x_im' = -x_im flipped on the A fragment), so a B fragment feeds 12 mma in
// the exact mode. Within a k16 step the mma go pass by pass over two groups at
// a time, so that two on one accumulator are four apart. A thread's
// accumulators hold x_re and x_im of the same bins: the power forms in
// registers, two n8 groups are the A fragment of one k16 step, and the
// filterbank product runs on the tensor cores straight from registers against
// the FBM fragments (read through the read-only cache), four mel tiles at a
// time. Each warp sums its q part's mel values in registers over every r; the
// q parts meet in shared memory at the end (added in a fixed order) and the
// block stores its frames, masking the ragged edge.
//
// What this does about the FP32 FFMA kernel it replaces (an earlier version
// of this file: 32 frames a block, 16 warps of 2 frames x 4 q, C/S through
// __ldg, 16 FFMA a pair of float4 loads, the filterbank a scalar __ldg FFMA
// loop at 2 FFMA a load that took 41 % of its time): both products run on the
// tensor cores, the filterbank's without leaving registers; each table
// fragment comes from L2 once for 64 frames, into shared memory once for
// eight warps.
//
// Bound on an H100 SXM. The function needs, per frame at DEFAULT_MEL
// (n_fft 2048, hop 384, 64 mels), a 2048-point real FFT, the window, the
// power and the filterbank's 1231 nonzero weights: ~64 kFLOP, 41.2 GFLOP for
// 1024 rows x 626 frames. Every product here has bf16 operands, so the
// rate is the tensor cores' 989 TFLOP/s: counted once for each of the three
// passes of the exact mode that is 0.125 ms, under the 0.410 ms the 1.37 GB
// of rows, tables and output take at 3.35 TB/s. Both modes are bound by
// their bytes (row 1: 0.410 ms; hop 320: 0.353 ms; the bf16 mode over the
// fast tier's 192 frames: 0.108 ms). This kernel's own form does ~3.6 MFLOP a
// frame in the exact mode (per r 128x128 outer products, two components for a
// complex r, three passes, and the 128 x n_mels filterbank product), 2.3
// TFLOP a batch at DEFAULT_MEL.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, B = 1024 (probes/
// kernel_variants.py): 12.8 ms exact at DEFAULT_MEL (the FFMA kernel it
// replaces 40.2 ms, one torch.stft call 17.8 ms), 15.4 ms at hop 320, 7.8 ms
// in the bf16 mode over all 626 frames; chip_smoke.py's times are in PERF.md.
// The first version of this file staged the window through registers and
// loaded the filterbank fragments one k16 step at a time: 13.5 / 16.0 / 8.9 ms.
//
// ptxas (nvcc 12.9, sm_90a), as ops/_build.py keeps it beside the library:
// 119-255 registers by instantiation, 1 barrier; the exact mode at 64 frames
// spills 32 bytes (<= 64 mels) and 336 bytes (128 mels), the others none.
//
// Ablations (template ABLATE, a mask; the reference's `ablate=`, :429-441,
// :472-485, :501-507, :602-613, :664-670, :709-721). `ncu` cannot run where
// this card is, so the cost of a class of work is measured as the time that
// goes when the class is dropped: AB_WINDOW (no Hann multiply), AB_INNER (the
// inner stage hands block r as a_re, block (r+1) % R as a_im), AB_POWER (p =
// x_re + x_im: both products stay live), AB_FB (the first n_mels power columns
// of each r stand for the filterbank product, unrounded), and in the exact
// mode AB_SPLITS (every split's lo = -hi: a distinct value, so no mma pass is
// removed) and AB_DOTS (one pass per logical product: a_hi*T_hi, and p_hi*F_hi
// for the filterbank). The output is wrong by design. An ablated
// instantiation is compiled only with -DMEL_POWER_CT_ABLATE=<mask>, into a
// library of its own that holds that mask alone: the serving library holds
// ABLATE = 0 alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mel_ct_inner.cuh"

namespace {

typedef __nv_bfloat16 bf16;

enum : int { AB_SPLITS = 16, AB_DOTS = 32 };  // AB_WINDOW .. AB_FB: mel_ct_inner.cuh

constexpr int NTHREADS = 256;     // 8 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int NB = CT_NB;         // CT block length (n2 and q range)
constexpr int LDA = NB + 8;       // bf16 per plane row (272 B: conflict-free ldmatrix)
constexpr int QGROUPS = NB / 8;   // n8 groups of q
constexpr int KSTEPS = NB / 16;   // k16 steps of one r's outer product
constexpr int STAGES = 3;         // ring buffers
constexpr int MAX_MEL_TILES = 16; // n_mels <= 128 (MEL_TILES 8: n_mels <= 64)
constexpr int MSET = 4;           // mel tiles whose filterbank mma's interleave

struct Params {
  const float* y;      // [B, L] rows
  const float* scale;  // [B] or nullptr
  const float* win;    // [n_fft] periodic Hann
  const float* wr;     // [R, 2] (cos, sin) of 2*pi*j/R
  const uint4* rhs;    // [(R/2+1)*8 k16 steps, 16 groups, parts, 32 lanes] (C w0 w1, S w0 w1)
  const uint2* fb;     // [(R/2+1)*8 k16 steps, mel tiles, 32 lanes, parts] (w0 w1)
  float* out;          // [B, T, n_mels]
  long long L;
  int T, n_fft, hop, n_mels, R;
  int frame0;  // first frame computed; out[:, t] is frame frame0 + t
  int pad_l;   // zeros before the row in the centre-padded signal
};

// D += A (16x16, row) * B (16x8, col), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16x16 tile whose row addresses this lane supplies
// (lanes 0-15: rows 0-15 at column 0; lanes 16-31: the same rows at column 8).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
// A 4-byte copy, or 4 zero bytes where `valid` is false (nothing is read then).
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Two f32 values as one bf16x2 word, the first in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16x2 word's two values negated (exact: the sign bits).
__device__ __forceinline__ uint32_t neg_bf16x2(uint32_t w) { return w ^ 0x80008000u; }

// Where the inner stage leaves plane k of its group at frame t: plane k0 of
// the group goes to slot 0, k1 to slot 1, the others are dropped; split into
// bf16 hi and (exact) lo, [slot][t0 + t][n2] with rows LDA apart.
template <bool EXACT, int ABLATE>
struct PlaneStore {
  bf16* hi;
  bf16* lo;
  int plane;  // bf16 between the two slots
  int n2, t0, k0, k1;
  __device__ __forceinline__ void operator()(int k, int t, float v) const {
    const int slot = k == k0 ? 0 : k == k1 ? 1 : -1;
    if (slot < 0) return;
    const int o = slot * plane + (t0 + t) * LDA + n2;
    const bf16 h = __float2bfloat16_rn(v);
    hi[o] = h;
    if (EXACT && !(ABLATE & AB_DOTS))
      lo[o] = __float2bfloat16_rn((ABLATE & AB_SPLITS) ? -__bfloat162float(h) : v - __bfloat162float(h));
  }
};

template <bool EXACT, int ABLATE, int TF, int MEL_TILES>
__global__ void __launch_bounds__(NTHREADS, 1)
mel_power_ct_kernel(Params p) {
  constexpr int MT = TF / 16;              // frame tiles of 16
  constexpr int QP = NWARPS / MT;          // q parts
  constexpr int G = QGROUPS / QP;          // n8 groups a warp
  constexpr bool DOTS = EXACT && (ABLATE & AB_DOTS);
  constexpr bool SPLITS = EXACT && (ABLATE & AB_SPLITS);
  constexpr int PASSES = EXACT && !DOTS ? 3 : 1;  // hi.hi, hi.lo, lo.hi
  constexpr int P = EXACT ? 2 : 1;         // parts of a table fragment: hi, lo
  constexpr int KS = EXACT ? 1 : 2;        // k16 steps a ring buffer
  constexpr int CHUNKS = KSTEPS / KS;      // ring buffers a r
  constexpr int STAGE_U4 = KS * QGROUPS * P * 32;
  constexpr int PLANE = TF * LDA;          // bf16 a plane, layout [t][n2]
  static_assert(G % 2 == 0 && G <= 8 && MEL_TILES >= G, "tile shape");

  extern __shared__ uint4 smem[];
  uint4* ring = smem;
  float* aud = reinterpret_cast<float*>(ring + STAGES * STAGE_U4);  // [n_aud] scaled, clipped samples
  const int n_aud = (TF - 1) * p.hop + p.n_fft;
  bf16* hi = reinterpret_cast<bf16*>(aud + ((n_aud + 3) & ~3));  // 2 x [TF][LDA] hi planes
  bf16* lo = hi + 2 * PLANE;                                       // 2 x [TF][LDA] lo planes

  const int b = blockIdx.y;
  const int t_base = blockIdx.x * TF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int mt = warp % MT, qp = warp / MT;
  const bool active = t_base + 16 * mt < p.T;  // the same for a whole warp
  const int R = p.R;
  const int n_half = R / 2 + 1;
  const int n_iter = n_half * CHUNKS;
  const int n_mel_tiles = (p.n_mels + 7) / 8;

  // the tile's audio window: samples (frame0 + t_base) * hop - pad_l ... of the
  // row, zeros outside it, copied without a round trip through registers (one
  // block fills an SM, so nothing else would hide the loads' latency)
  {
    const long long g0 = (long long)(p.frame0 + t_base) * p.hop - p.pad_l;
    const float* yrow = p.y + (long long)b * p.L;
    for (int i = threadIdx.x; i < n_aud; i += NTHREADS) {
      const long long g = g0 + i;
      const bool valid = g >= 0 && g < p.L;
      cp_async4_zfill(aud + i, valid ? yrow + g : yrow, valid);
    }
    cp_async_commit();
  }
  // ring buffer i = (r, chunk) of the outer tables, r in order
  auto issue = [&](int i, int slot) {
    const uint4* src = p.rhs + (size_t)i * STAGE_U4;
    uint4* dst = ring + slot * STAGE_U4;
    for (int u = threadIdx.x; u < STAGE_U4; u += NTHREADS) cp_async16(dst + u, src + u);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_iter) issue(s, s);
    cp_async_commit();
  }
  // fused RMS scale and clip in place (mel_stage.cuh's contract): s > 0 ->
  // clip(y*s, -1, 1), s <= 0 -> raw
  const float sc = p.scale != nullptr ? p.scale[b] : -1.f;
  cp_async_wait<STAGES - 1>();  // the window has landed (the ring's first buffers may not have)
  __syncthreads();
  if (sc > 0.f)
    for (int i = threadIdx.x; i < n_aud; i += NTHREADS) aud[i] = fminf(fmaxf(aud[i] * sc, -1.f), 1.f);

  // this lane's ldmatrix row address: frame 16 mt + (lane & 15), column (lane >> 4) * 8
  const uint32_t a_off = (uint32_t)(((16 * mt + (lane & 15)) * LDA + (lane >> 4) * 8) * (int)sizeof(bf16));
  const uint32_t a_hi = (uint32_t)__cvta_generic_to_shared(hi) + a_off;
  const uint32_t a_lo = (uint32_t)__cvta_generic_to_shared(lo) + a_off;
  constexpr uint32_t SLOT_BYTES = PLANE * sizeof(bf16);

  float mel[MEL_TILES][4];
#pragma unroll
  for (int n = 0; n < MEL_TILES; ++n)
#pragma unroll
    for (int k = 0; k < 4; ++k) mel[n][k] = 0.f;

  const int n2 = threadIdx.x % NB;
  const int tsub = threadIdx.x / NB;  // 2 frame lanes; one pass covers frames tsub + 4i
  int it = 0;                         // ring buffers consumed

#pragma unroll 1
  for (int r = 0; r < n_half; ++r) {
    const bool has_im = !(r == 0 || 2 * r == R);
    __syncthreads();  // every warp is done with the previous r's planes (and the window is staged)
    // the inner stage for this r alone, in two passes of frames (tsub + 4i, then + 2)
    if (R == 16) {
      float w[16];
#pragma unroll
      for (int n1 = 0; n1 < 16; ++n1) w[n1] = __ldg(p.win + n1 * NB + n2);
      // planes of the group r0 = r mod 4: r0 == 0: 0 -> r 0, 1/2 -> r 4, 3 -> r 8;
      // else 0/1 -> r0, 2/3 -> r0 + 4
      const int r0 = r & 3;
      const int k0 = r0 == 0 ? (r == 0 ? 0 : r == 4 ? 1 : 3) : (r < 4 ? 0 : 2);
      const int k1 = r0 == 0 ? (r == 4 ? 2 : -1) : k0 + 1;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        inner_group16<ABLATE, TF>(r0, aud + 2 * h * p.hop, p.hop, w, p.wr, n2, tsub,
                                  PlaneStore<EXACT, ABLATE>{hi, lo, PLANE, n2, 2 * h, k0, k1});
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        inner_generic<ABLATE, TF>(aud + 2 * h * p.hop, p.hop, p.win, p.wr, R, r, n2, tsub,
                                  PlaneStore<EXACT, ABLATE>{hi, lo, PLANE, n2, 2 * h, 0, has_im ? 1 : -1});
    }

    // outer stage: x_re | x_im' (= -x_im) of this warp's groups, summed over
    // the ring buffers in round-to-nearest f32
    float sre[G][4], sim[G][4];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) sre[j][k] = sim[j][k] = 0.f;

#pragma unroll 1
    for (int ch = 0; ch < CHUNKS; ++ch, ++it) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // buffer `it` has landed (the planes too); every warp is done with buffer it - 1
      if (it + STAGES - 1 < n_iter) issue(it + STAGES - 1, (it + STAGES - 1) % STAGES);
      cp_async_commit();
      if (!active) continue;

      float xr[G][4], xi[G][4];
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) xr[j][k] = xi[j][k] = 0.f;
      const uint4* st = ring + (it % STAGES) * STAGE_U4 + lane;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t kb = (uint32_t)((ch * KS + ks) * 16 * sizeof(bf16));
        // A fragments: [component re, im][part hi, lo]; the im ones negated for x_im'
        uint32_t a[2][2][4], an[2][4];
        ldmatrix_x4(a[0][0], a_hi + kb);
        if (PASSES == 3) ldmatrix_x4(a[0][1], a_lo + kb);
        if (has_im) {
          ldmatrix_x4(a[1][0], a_hi + SLOT_BYTES + kb);
          if (PASSES == 3) ldmatrix_x4(a[1][1], a_lo + SLOT_BYTES + kb);
#pragma unroll
          for (int part = 0; part < (PASSES == 3 ? 2 : 1); ++part)
#pragma unroll
            for (int e = 0; e < 4; ++e) an[part][e] = neg_bf16x2(a[1][part][e]);
        }
#pragma unroll
        for (int j0 = 0; j0 < G; j0 += 2) {
          uint4 bh[2], bl[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int grp = qp * G + j0 + j;
            bh[j] = st[((ks * QGROUPS + grp) * P) * 32];
            if (PASSES == 3) bl[j] = st[((ks * QGROUPS + grp) * P + 1) * 32];
          }
#pragma unroll
          for (int comp = 0; comp < 2; ++comp) {
            if (comp == 1 && !has_im) break;
#pragma unroll
            for (int pass = 0; pass < PASSES; ++pass)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const uint4 bw = pass == 1 ? bl[j] : bh[j];  // hi.hi, hi.lo, lo.hi
                const int part = pass == 2 ? 1 : 0;
                if (comp == 0) {  // a_re: x_re += a C, x_im' += a S
                  mma_bf16(xr[j0 + j], a[0][part], bw.x, bw.y);
                  mma_bf16(xi[j0 + j], a[0][part], bw.z, bw.w);
                } else {  // a_im: x_re += a S, x_im' += (-a) C
                  mma_bf16(xr[j0 + j], a[1][part], bw.z, bw.w);
                  mma_bf16(xi[j0 + j], an[part], bw.x, bw.y);
                }
              }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sre[j][k] = __fadd_rn(sre[j][k], xr[j][k]);
          sim[j][k] = __fadd_rn(sim[j][k], xi[j][k]);
        }
    }
    if (!active) continue;

    // power in registers. Register k of group j holds bin 8j + 2c + (k & 1) of
    // frame g + 8 (k >> 1); groups 2u, 2u + 1 are the A fragment of k16 step u.
    if (ABLATE & AB_FB) {  // the first n_mels power columns, unrounded
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          mel[j][k] = __fadd_rn(mel[j][k], (ABLATE & AB_POWER) ? __fsub_rn(sre[j][k], sim[j][k])
                                                               : __fadd_rn(__fmul_rn(sre[j][k], sre[j][k]),
                                                                           __fmul_rn(sim[j][k], sim[j][k])));
      continue;
    }
    uint32_t ph[G / 2][4], pl[G / 2][4];
#pragma unroll
    for (int u = 0; u < G / 2; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          float pw[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = sre[2 * u + h][2 * row + e], y = sim[2 * u + h][2 * row + e];
            // AB_POWER: p = x_re + x_im = x_re - x_im'
            pw[e] = (ABLATE & AB_POWER) ? __fsub_rn(x, y) : __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
          }
          const uint32_t w = pack_bf16(pw[0], pw[1]);
          ph[u][2 * h + row] = w;
          if (PASSES == 3) {  // the lo half is formed in f32 from the rounded hi half
            const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&w);
            pl[u][2 * h + row] = SPLITS ? neg_bf16x2(w) : pack_bf16(pw[0] - __low2float(hv), pw[1] - __high2float(hv));
          }
        }

    // filterbank product of this warp's q part: each mel tile summed from
    // zero on the tensor cores, MSET tiles interleaved, then added
    const uint2* fbp = p.fb + ((size_t)(r * KSTEPS + qp * (G / 2)) * n_mel_tiles * 32 + lane) * P;
#pragma unroll
    for (int n0 = 0; n0 < MEL_TILES; n0 += MSET) {
      if (n0 >= n_mel_tiles) break;
      // every fragment of these MSET tiles first: one trip to L2, not one a k16 step
      uint4 fw[G / 2][MSET];
#pragma unroll
      for (int u = 0; u < G / 2; ++u)
#pragma unroll
        for (int n = 0; n < MSET; ++n) {
          if (n0 + n >= n_mel_tiles) continue;
          const uint2* f = fbp + ((size_t)u * n_mel_tiles + n0 + n) * 32 * P;
          if (EXACT) {
            fw[u][n] = __ldg(reinterpret_cast<const uint4*>(f));
          } else {
            const uint2 v = __ldg(f);
            fw[u][n] = make_uint4(v.x, v.y, 0u, 0u);
          }
        }
      float d[MSET][4];
#pragma unroll
      for (int n = 0; n < MSET; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) d[n][k] = 0.f;
#pragma unroll
      for (int u = 0; u < G / 2; ++u) {
#pragma unroll
        for (int pass = 0; pass < PASSES; ++pass)
#pragma unroll
          for (int n = 0; n < MSET; ++n) {
            if (n0 + n >= n_mel_tiles) continue;
            if (pass == 0) mma_bf16(d[n], ph[u], fw[u][n].x, fw[u][n].y);       // p_hi F_hi
            else if (pass == 1) mma_bf16(d[n], ph[u], fw[u][n].z, fw[u][n].w);  // p_hi F_lo
            else mma_bf16(d[n], pl[u], fw[u][n].x, fw[u][n].y);                 // p_lo F_hi
          }
      }
#pragma unroll
      for (int n = 0; n < MSET; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) mel[n0 + n][k] = __fadd_rn(mel[n0 + n][k], d[n][k]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the planes: the window and planes become `red`

  // the q parts meet in shared memory: red[qp][t][m], rows RS floats apart
  float* red = aud;
  const int RS = 8 * n_mel_tiles + 8;
  if (active) {
#pragma unroll
    for (int n = 0; n < MEL_TILES; ++n) {
      // AB_FB: this warp's group n stands for mel tile qp G + n
      const int tile = (ABLATE & AB_FB) ? qp * G + n : n;
      if (((ABLATE & AB_FB) && n >= G) || tile >= n_mel_tiles) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = 16 * mt + g + 8 * h;
        *reinterpret_cast<float2*>(red + (qp * TF + t) * RS + 8 * tile + 2 * c) =
            make_float2(mel[n][2 * h], mel[n][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  const int n_t = min(TF, p.T - t_base);
  for (int idx = threadIdx.x; idx < n_t * p.n_mels; idx += NTHREADS) {
    const int t = idx / p.n_mels, m = idx % p.n_mels;
    float v;
    if (ABLATE & AB_FB) {
      v = red[((m / 8) / G * TF + t) * RS + m];
    } else {
      v = red[t * RS + m];
#pragma unroll
      for (int q = 1; q < QP; ++q) v = __fadd_rn(v, red[(q * TF + t) * RS + m]);
    }
    p.out[((long long)b * p.T + t_base + t) * p.n_mels + m] = v;
  }
}

using Kernel = void (*)(Params);

#ifndef MEL_POWER_CT_ABLATE
#define MEL_POWER_CT_ABLATE 0
#endif

template <bool EXACT, int MEL_TILES>
Kernel pick_tf(int tf) {
  constexpr int A = MEL_POWER_CT_ABLATE;
  if (tf == 64) return mel_power_ct_kernel<EXACT, A, 64, MEL_TILES>;
  if (tf == 32) return mel_power_ct_kernel<EXACT, A, 32, MEL_TILES>;
  if (tf == 16) return mel_power_ct_kernel<EXACT, A, 16, MEL_TILES>;
  return nullptr;
}

// The instantiation for (mode, ablation mask, frame tile, mels); nullptr
// unless the mask is this library's (splits and dots: exact mode only).
Kernel pick_kernel(int bf16, int ablate, int tf, int n_mels) {
  if (ablate != MEL_POWER_CT_ABLATE) return nullptr;
  if (bf16) {
    if (ablate & (AB_SPLITS | AB_DOTS)) return nullptr;
    return n_mels <= 64 ? pick_tf<false, 8>(tf) : pick_tf<false, MAX_MEL_TILES>(tf);
  }
  return n_mels <= 64 ? pick_tf<true, 8>(tf) : pick_tf<true, MAX_MEL_TILES>(tf);
}

}  // namespace

extern "C" {

// Shared memory (bytes) of the kernel with `tf` frames a block: the ring of
// table fragments, then the f32 window of (tf-1)*hop + n_fft samples and two
// [tf][136] bf16 planes (hi and lo in the exact mode), which at the end hold
// the q parts' mel values instead ([128][136] f32 at most: 128 mels); mirrored
// by ops/mel_kernel.py `ct_smem_bytes`.
long long mel_power_ct_smem_bytes(int n_fft, int hop, int tf, int bf16) {
  const long long parts = bf16 ? 1 : 2;
  const long long ks = bf16 ? 2 : 1;
  const long long ring = STAGES * ks * QGROUPS * parts * 512;
  const long long n_aud = (long long)(tf - 1) * hop + n_fft;
  const long long work = ((n_aud + 3) & ~3LL) * 4 + 2 * parts * tf * LDA * 2;
  const long long red = 128LL * (8 * MAX_MEL_TILES + 8) * 4;
  return ring + (work > red ? work : red);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `rhs` / `fb` are the fragment tables of the mode (`bf16` != 0: the bf16
// mode's), as ops/mel_kernel.py `ct_split_fragment_tables` builds them.
// `ablate` is a mask of AB_* classes (profiling only); it must be the mask
// the library was built for (-DMEL_POWER_CT_ABLATE=<mask>, 0 without).
int mel_power_ct_launch(const float* y, long long L, const float* scale, const void* rhs,
                        const void* fb, const float* win, const float* wr, float* out, int B,
                        int T, int frame0, int pad_l, int n_fft, int hop, int n_mels, int tf,
                        int bf16, int ablate, void* stream) {
  if (n_fft % NB != 0 || n_fft < 2 * NB || n_mels < 1 || n_mels > 8 * MAX_MEL_TILES ||
      B < 1 || T < 1 || B > 65535 || hop < 1 || frame0 < 0 || pad_l < 0)
    return (int)cudaErrorInvalidValue;
  Kernel kernel = pick_kernel(bf16, ablate, tf, n_mels);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  Params p;
  p.y = y; p.scale = scale; p.win = win; p.wr = wr;
  p.rhs = static_cast<const uint4*>(rhs); p.fb = static_cast<const uint2*>(fb);
  p.out = out; p.L = L; p.T = T; p.n_fft = n_fft; p.hop = hop;
  p.n_mels = n_mels; p.R = n_fft / NB; p.frame0 = frame0; p.pad_l = pad_l;
  const long long smem = mel_power_ct_smem_bytes(n_fft, hop, tf, bf16);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + tf - 1) / tf, B);
  kernel<<<grid, NTHREADS, (size_t)smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
