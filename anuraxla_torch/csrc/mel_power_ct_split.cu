// Fused mel power with the outer stage as ONE deep product per r over bf16
// split operands, on Hopper's tensor cores: PCM rows -> [B, T, n_mels] f32.
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
// Design. One block of 512 threads owns one row and a tile of TF = 32 frames.
// The inner stage writes the hi and lo planes of a group
// of r to shared memory once, as bf16. The concatenation the TPU kernel
// materialises along lanes is never formed: the K loop reads segment s from
// plane (hi, hi, lo)[s], and the hi fragments serve both of their segments.
// Products run on the tensor cores with mma.sync.m16n8k16 (bf16 operands, f32
// accumulators in registers). Warp w owns the x_re columns 8w..8w+7 and the
// x_im columns 128+8w.. of all 32 frames (16 accumulator registers a
// thread), so a thread holds both parts of its bins and forms the power in
// registers. A fragments come from shared memory with 32-bit loads; plane
// rows are 136 bf16 (272 B) apart, which spreads a fragment's 32 words over
// the 32 banks. B fragments come from global memory: the host lays the RHS
// and filterbank tables out in fragment order (ops/mel_kernel.py,
// `ct_fragment_tables`), so one 16-byte load a lane feeds four `mma`s and a
// warp's load is contiguous; the tables (3.5 MB + 0.4 MB at n_fft 2048, 64
// mels) stay in L2. The split power goes to shared memory as bf16 and the
// filterbank product is a second, small `mma` stage: warp w owns 16 frames x
// 8 mels, summed from zero for each r and added to the running mel in f32.
//
// Bound on an H100 SXM. The function's least work is that of
// mel_power_ct.cu (41.2 GFLOP for 1024 rows x 626 frames at n_fft 2048 / hop
// 384 / 64 mels), but every product here has bf16 operands, so its rate is
// the tensor cores' 989 TFLOP/s: even counted once for each of the three
// passes of the split that is 0.125 ms, under the 0.410 ms the 1.37 GB of
// rows, tables and output take at 3.35 TB/s. Both modes are bound by their
// bytes (the bf16 mode over the fast tier's 192 frames: 0.108 ms), and
// 11.4 ms is 3.6 % of that bound. This kernel's own form does 3.59 MFLOP a frame in exact mode (7 complex r of 32x768x256, 2
// real of 32x384x256, 9 filterbank products of 32x384x64 a tile), ~2.3 TFLOP a
// batch. With 32 frames a block every block streams the whole RHS table from
// L2 (3.9 MB a block, ~80 GB a batch), which is what bounds this first
// version; more frames a block, `wgmma` and TMA are later work. Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W for that batch: 11.4 ms
// exact (the FP32 FFMA kernel 40.4 ms, one torch.stft call 17.6 ms), 1.9 ms
// in the bf16 mode over the fast tier's 192 frames.
//
// The tensor cores' f32 accumulator is not an IEEE round-to-nearest chain;
// chip_smoke.py holds the kernel to its plain version with f64 sums and
// prints worst and mean beside the plain version's own.
//
// ptxas (nvcc 12.9, sm_90a), as ops/_build.py keeps it beside the library:
// exact mode 106 registers, bf16 mode 96, 1 barrier each, 0 bytes stack frame,
// 0 bytes spill stores, 0 bytes spill loads; one block of 512 threads an SM
// (142.8 KB of shared memory at n_fft 2048 / hop 384).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mel_ct_inner.cuh"
#include "mel_stage.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TF = 32;          // frames per block: two m16 tiles
constexpr int NTHREADS = 512;   // 16 warps
constexpr int NB = CT_NB;       // CT block length (n2 and q range)
constexpr int LDA = NB + 8;     // bf16 per plane row (272 B: conflict-free fragments)
constexpr int PLANE = TF * LDA; // bf16 per plane, layout [t][n2]
constexpr int SEG_STEPS = NB / 16;  // k16 steps per 128-wide segment
constexpr int MAX_FB_TILES = 2; // 16-frame x 8-mel tiles a warp: n_mels <= 128

struct Params {
  const float* y;      // [B, L] rows
  const float* scale;  // [B] or nullptr
  const float* win;    // [n_fft] periodic Hann
  const float* wr;     // [R, 2] (cos, sin) of 2*pi*j/R
  const uint4* rhs;    // [k16 steps of every r, 16 warps, 32 lanes] B fragments
  const uint2* fb;     // [(R/2+1) * k1 steps, mel tiles, 32 lanes] B fragments
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

// The A fragment of the 16x16 tile at `tile` (row stride LDA): lane 4g + c
// holds rows g and g + 8, columns 2c, 2c+1 and 2c+8, 2c+9.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int g, int c) {
  const uint32_t* r0 = reinterpret_cast<const uint32_t*>(tile + g * LDA + 2 * c);
  const uint32_t* r1 = reinterpret_cast<const uint32_t*>(tile + (g + 8) * LDA + 2 * c);
  a[0] = r0[0];
  a[1] = r1[0];
  a[2] = r0[4];
  a[3] = r1[4];
}

// Outer stage for one r: x_re | x_im = L @ RHS_r on the tensor cores, then
// the power, split, to `p_hi` / `p_lo` [t][q]. `kstep0` is the first k16 step
// of RHS_r in the fragment table; `hi` / `lo` point at the a_re planes, the
// a_im planes follow one plane later.
template <bool EXACT, bool HAS_IM>
__device__ __forceinline__ void outer_power(const Params& p, int kstep0,
                                            const bf16* __restrict__ hi,
                                            const bf16* __restrict__ lo,
                                            bf16* __restrict__ p_hi,
                                            bf16* __restrict__ p_lo) {
  constexpr int PARTS = EXACT ? 3 : 1;  // segments of a component: hi, hi, lo
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  float xr[2][4], xi[2][4];  // [frame tile][fragment register]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { xr[i][j] = 0.f; xi[i][j] = 0.f; }

  const uint4* bp = p.rhs + ((size_t)kstep0 * 16 + warp) * 32 + lane;
  constexpr size_t STEP = 16 * 32;  // uint4 per k16 step
#pragma unroll
  for (int comp = 0; comp < (HAS_IM ? 2 : 1); ++comp) {
    const bf16* ahi = hi + comp * PLANE;
    const bf16* alo = lo + comp * PLANE;
    const uint4* bc = bp + (size_t)comp * PARTS * SEG_STEPS * STEP;
#pragma unroll 2
    for (int k = 0; k < SEG_STEPS; ++k) {
      uint4 b[PARTS];
#pragma unroll
      for (int s = 0; s < PARTS; ++s) b[s] = __ldg(bc + (size_t)(s * SEG_STEPS + k) * STEP);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t a[4];
        load_a(a, ahi + mt * 16 * LDA + 16 * k, g, c);
        // segments 0 and 1 share the hi fragment: a_hi * T_hi + a_hi * T_lo
#pragma unroll
        for (int s = 0; s < (EXACT ? 2 : 1); ++s) {
          mma_bf16(xr[mt], a, b[s].x, b[s].y);
          mma_bf16(xi[mt], a, b[s].z, b[s].w);
        }
        if (EXACT) {  // segment 2: a_lo * T_hi
          load_a(a, alo + mt * 16 * LDA + 16 * k, g, c);
          mma_bf16(xr[mt], a, b[2].x, b[2].y);
          mma_bf16(xi[mt], a, b[2].z, b[2].w);
        }
      }
    }
  }

  // a thread holds x_re and x_im of its bins: rows g / g + 8 of each frame
  // tile, columns q, q + 1
  const int q = 8 * warp + 2 * c;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = (16 * mt + g + 8 * h) * LDA + q;
      const float p0 = xr[mt][2 * h] * xr[mt][2 * h] + xi[mt][2 * h] * xi[mt][2 * h];
      const float p1 = xr[mt][2 * h + 1] * xr[mt][2 * h + 1] + xi[mt][2 * h + 1] * xi[mt][2 * h + 1];
      const bf16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
      *reinterpret_cast<__nv_bfloat162*>(p_hi + o) = __halves2bfloat162(h0, h1);
      if (EXACT)  // the lo half is formed in f32, before the second product
        *reinterpret_cast<__nv_bfloat162*>(p_lo + o) =
            __halves2bfloat162(__float2bfloat16_rn(p0 - __bfloat162float(h0)),
                               __float2bfloat16_rn(p1 - __bfloat162float(h1)));
    }
}

// Filterbank product for one r: mel += [p_hi p_hi p_lo] @ FBCAT_r, each
// tile summed from zero on the tensor cores and added to the running mel.
template <bool EXACT>
__device__ __forceinline__ void fb_accumulate(const Params& p, int r,
                                              const bf16* __restrict__ p_hi,
                                              const bf16* __restrict__ p_lo,
                                              float (&mel)[MAX_FB_TILES][4]) {
  constexpr int PARTS = EXACT ? 3 : 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int n_tiles = (p.n_mels + 7) / 8;
  const size_t step = (size_t)n_tiles * 32;  // uint2 per k16 step
#pragma unroll
  for (int j = 0; j < MAX_FB_TILES; ++j) {
    const int tile = warp + 16 * j;
    const int mt = tile & 1, nt = tile >> 1;
    if (nt >= n_tiles) continue;  // the same for a whole warp
    const uint2* bp = p.fb + (size_t)r * PARTS * SEG_STEPS * step + (size_t)nt * 32 + lane;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int k = 0; k < SEG_STEPS; ++k) {
      uint2 b[PARTS];
#pragma unroll
      for (int s = 0; s < PARTS; ++s) b[s] = __ldg(bp + (size_t)(s * SEG_STEPS + k) * step);
      uint32_t a[4];
      load_a(a, p_hi + mt * 16 * LDA + 16 * k, g, c);
      mma_bf16(d, a, b[0].x, b[0].y);
      if (EXACT) {
        mma_bf16(d, a, b[1].x, b[1].y);
        load_a(a, p_lo + mt * 16 * LDA + 16 * k, g, c);
        mma_bf16(d, a, b[2].x, b[2].y);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) mel[j][i] += d[i];
  }
}

// Where the inner stage leaves plane k of its group at frame t: split into
// bf16 hi and (exact mode) lo, [k][t][n2] with rows LDA apart.
template <bool EXACT>
struct SplitStore {
  bf16* hi;
  bf16* lo;
  int n2;
  __device__ __forceinline__ void operator()(int k, int t, float v) const {
    const bf16 h = __float2bfloat16_rn(v);
    hi[k * PLANE + t * LDA + n2] = h;
    if (EXACT) lo[k * PLANE + t * LDA + n2] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
};

// One r through outer stage, power and filterbank, with the block barriers
// that separate the A planes, the power tile and the next writer. `k_re`:
// the plane of a_re in the group; a_im, where r has one, is the next plane.
template <bool EXACT>
__device__ __forceinline__ void do_r(const Params& p, int r, const bf16* hi, const bf16* lo,
                                     int k_re, bool has_im, bf16* p_hi, bf16* p_lo,
                                     float (&mel)[MAX_FB_TILES][4]) {
  // RHS blocks lie in r order: r = 0 is real-only, every r in between complex
  const int k1 = (EXACT ? 3 : 1) * SEG_STEPS;
  const int kstep0 = r == 0 ? 0 : k1 * (1 + 2 * (r - 1));
  if (has_im) outer_power<EXACT, true>(p, kstep0, hi + k_re * PLANE, lo + k_re * PLANE, p_hi, p_lo);
  else outer_power<EXACT, false>(p, kstep0, hi + k_re * PLANE, lo + k_re * PLANE, p_hi, p_lo);
  __syncthreads();
  fb_accumulate<EXACT>(p, r, p_hi, p_lo, mel);
  __syncthreads();
}

template <bool EXACT>
__global__ void __launch_bounds__(NTHREADS, 1)
mel_power_ct_split_kernel(Params p) {
  extern __shared__ float smem[];
  const int n_aud = (TF - 1) * p.hop + p.n_fft;
  float* aud = smem;  // [n_aud] scaled, clipped samples
  bf16* hi = reinterpret_cast<bf16*>(aud + ((n_aud + 3) & ~3));  // 4 x [TF][LDA] hi planes
  bf16* lo = hi + 4 * PLANE;                                      // 4 x [TF][LDA] lo planes
  bf16* p_hi = lo + 4 * PLANE;                                    // [TF][LDA] split power
  bf16* p_lo = p_hi + PLANE;

  const int b = blockIdx.y;
  const int t_base = blockIdx.x * TF;
  const float* yrow = p.y + (long long)b * p.L;
  const float s = p.scale != nullptr ? p.scale[b] : -1.f;

  // the window and the inner stage run in f32 in both modes
  stage_audio(aud, n_aud, yrow, p.L,
                     (long long)(p.frame0 + t_base) * p.hop, p.pad_l, s);
  __syncthreads();

  float mel[MAX_FB_TILES][4];
#pragma unroll
  for (int j = 0; j < MAX_FB_TILES; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) mel[j][i] = 0.f;

  const int n2 = threadIdx.x % NB;
  const int tsub = threadIdx.x / NB;
  const int R = p.R;
  const SplitStore<EXACT> store{hi, lo, n2};

  if (R == 16) {
    float w[16];
#pragma unroll
    for (int n1 = 0; n1 < 16; ++n1) w[n1] = __ldg(p.win + n1 * NB + n2);
    // groups by r0 = r mod 4: {0, 4, 8}, {1, 5}, {2, 6}, {3, 7}
    inner_group16<0, TF>(0, aud, p.hop, w, p.wr, n2, tsub, store);
    __syncthreads();
    do_r<EXACT>(p, 0, hi, lo, 0, false, p_hi, p_lo, mel);
    do_r<EXACT>(p, 4, hi, lo, 1, true, p_hi, p_lo, mel);
    do_r<EXACT>(p, 8, hi, lo, 3, false, p_hi, p_lo, mel);
    inner_group16<0, TF>(1, aud, p.hop, w, p.wr, n2, tsub, store);
    __syncthreads();
    do_r<EXACT>(p, 1, hi, lo, 0, true, p_hi, p_lo, mel);
    do_r<EXACT>(p, 5, hi, lo, 2, true, p_hi, p_lo, mel);
    inner_group16<0, TF>(2, aud, p.hop, w, p.wr, n2, tsub, store);
    __syncthreads();
    do_r<EXACT>(p, 2, hi, lo, 0, true, p_hi, p_lo, mel);
    do_r<EXACT>(p, 6, hi, lo, 2, true, p_hi, p_lo, mel);
    inner_group16<0, TF>(3, aud, p.hop, w, p.wr, n2, tsub, store);
    __syncthreads();
    do_r<EXACT>(p, 3, hi, lo, 0, true, p_hi, p_lo, mel);
    do_r<EXACT>(p, 7, hi, lo, 2, true, p_hi, p_lo, mel);
  } else {
    // literal-weight R-point DFT, one r at a time
    for (int r = 0; r <= R / 2; ++r) {
      inner_generic<0, TF>(aud, p.hop, p.win, p.wr, R, r, n2, tsub, store);
      __syncthreads();
      do_r<EXACT>(p, r, hi, lo, 0, !(r == 0 || 2 * r == R), p_hi, p_lo, mel);
    }
  }

  // store, masking the ragged frame edge and the padded mel columns
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < MAX_FB_TILES; ++j) {
    const int tile = warp + 16 * j;
    const int mt = tile & 1, nt = tile >> 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t_base + 16 * mt + g + 8 * (i >> 1);
      const int m = 8 * nt + 2 * c + (i & 1);
      if (t < p.T && m < p.n_mels) p.out[((long long)b * p.T + t) * p.n_mels + m] = mel[j][i];
    }
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) the kernel needs for (n_fft, hop), either mode.
long long mel_power_ct_split_smem_bytes(int n_fft, int hop) {
  const long long n_aud = (long long)(TF - 1) * hop + n_fft;
  return ((n_aud + 3) & ~3LL) * (long long)sizeof(float) + 10LL * PLANE * (long long)sizeof(bf16);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `rhs` / `fb` are the fragment tables of the mode (`bf16` != 0: the bf16
// mode's), as ops/mel_kernel.py `ct_fragment_tables` builds them.
int mel_power_ct_split_launch(const float* y, long long L, const float* scale,
                              const void* rhs, const void* fb, const float* win,
                              const float* wr, float* out, int B, int T, int frame0,
                              int pad_l, int n_fft, int hop, int n_mels, int bf16,
                              void* stream) {
  if (n_fft % NB != 0 || n_fft < 2 * NB || n_mels < 1 || n_mels > 64 * MAX_FB_TILES ||
      B < 1 || T < 1 || B > 65535 || hop < 1 || frame0 < 0 || pad_l < 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.y = y; p.scale = scale; p.win = win; p.wr = wr;
  p.rhs = static_cast<const uint4*>(rhs); p.fb = static_cast<const uint2*>(fb);
  p.out = out; p.L = L; p.T = T; p.n_fft = n_fft; p.hop = hop;
  p.n_mels = n_mels; p.R = n_fft / NB; p.frame0 = frame0; p.pad_l = pad_l;
  const long long smem = mel_power_ct_split_smem_bytes(n_fft, hop);
  auto kernel = bf16 ? mel_power_ct_split_kernel<false> : mel_power_ct_split_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TF - 1) / TF, B);
  kernel<<<grid, NTHREADS, (size_t)smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
