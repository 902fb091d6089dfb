// Fused mel power on Hopper: PCM rows -> [B, T, n_mels] f32.
//
// Replaces three TPU kernels of anuraxla/ops/pallas_frontend.py, which
// compute one function and differ in how Mosaic lets them assemble frames:
//   - `_mel_power_ctp_kernel` (:567), exact mode, hop % 128 == 0, as
//     `mel_power_pallas` drives it from its phase branch (:1030-1172);
//   - the same kernel with exact=False (`_ct_outer_stage` :493-508): one
//     bf16 pass per product (template BF16 below);
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
// is pre-padded), for frames t0 .. t0+T-1 (t0 > 0: the crop-first frontend
// computes only the frames that survive the centre crop), with the
// Cooley-Tukey split n = n1*128 + n2 (n1 < R = n_fft/128) and
// k = q*R + r. Per frame:
//   inner stage  A_r[n2] = sum_n1 x[n1*128 + n2] * W_R^(n1*r), only r <= R/2
//                (radix 4x4 for R = 16, a literal-weight sum for other R);
//   outer stage  X_r[q] = A_r @ (C_r - i S_r) against the twiddle-folded
//                tables C/S (cos/sin of 2*pi*n2*(q*R + r)/n_fft);
//   power + mel  mel += |X_r|^2 @ FBM_r, FBM the merged filterbank that
//                folds the conjugate partner block R - r into block r.
// Frames and spectra never leave the SM.
//
// Design. One block of 512 threads owns one row and a tile of TF = 32
// frames. The tile's audio window ((TF-1)*hop + n_fft samples) is scaled,
// clipped and staged in shared memory once. The inner stage writes the
// A_r planes of one group of r (the r sharing r mod 4 for R = 16; a single
// r otherwise) to shared memory; the outer stage is then a small register-
// tiled FP32 GEMM per r (each thread 2 frames x 4 q, complex), C/S read
// through the read-only cache (they stay resident in L2: C + S + FBM are
// ~1.5 MB at n_fft 2048). Power goes to shared memory and the filterbank
// product accumulates mel in registers across all r. The ragged frame edge
// is masked at the store.
//
// Exactness. Plain FP32 FFMA throughout with f32 tables built from a
// float64 construction: this meets the exact tier's bound (6.2e-6 relative
// on mel power against the f32 HIGHEST oracle). One TF32 tensor-core pass
// would not.
//
// bf16 mode (BF16 = true). The TPU kernel's rounding points exactly: the
// inner-stage planes a_re / a_im and the power p are rounded to bf16 where
// they are written to shared memory, and the caller passes C/S/FBM tables
// that hold the bf16 `hi` halves. Window and inner stage stay f32; every
// product then has two bf16 operands, is exact in f32, and accumulates in
// f32. This first version runs the same FFMA loops as the exact mode, so it
// is no faster; mma.sync / wgmma on the rounded operands is the speed path.
//
// Any hop. Frames are read from the staged window at t*hop + n1*128 + n2
// with scalar shared-memory loads: neighbouring threads read neighbouring
// n2, so no 128-sample alignment of t*hop is assumed and no bank conflict
// arises at hop = 32 * odd. Shared memory grows with hop ((TF-1)*hop +
// n_fft staged samples): 152 KB at n_fft 2048 / hop 512.
//
// Bound on an H100 SXM. The function needs, per frame at DEFAULT_MEL
// (n_fft 2048, hop 384, 64 mels), a 2048-point real FFT (~56 kFLOP), the
// window, the power and the filterbank's 1231 nonzero weights: ~64 kFLOP.
// x 626 frames x B = 1024 that is ~41 GFLOP, ~0.62 ms at the card's
// 67 TFLOP/s FP32 (non-tensor) rate; the 1.37 GB of rows, tables and output
// take ~0.41 ms at 3.35 TB/s. So the bound is ~0.62 ms, by operations.
// This kernel's GEMM form does ~20x that work (~1.27 MFLOP per frame: 7
// complex + 2 real 128x128 outer products, 9 merged-filterbank products,
// the inner stage; ~0.81 TFLOP, ~12 ms at the FP32 rate), so its speed is
// the FFMA issue rate of the outer GEMMs and it sits far from the bound.
//
// Ablations (template ABLATE; the reference's `ablate=`, :402-509 and
// :602-613, :664-670, :709-721). `ncu` cannot run where this card is, so
// the cost of a class of work is measured as the time that goes when the
// class is dropped: AB_WINDOW (no Hann multiply), AB_INNER (the inner stage
// hands block r as a_re, block (r+1) % R as a_im), AB_POWER (p = x_re + x_im:
// both products stay live, or the compiler would remove the imaginary half
// of the outer stage with the squares), AB_FB (the first n_mels power
// columns stand for the filterbank product). The output is wrong by design.
// An ablated instantiation is compiled only with -DMEL_POWER_CT_ABLATE=<mask>,
// into a library of its own that holds that mask alone (both modes): the
// serving library holds ABLATE = 0 alone, and a profiling run builds only the
// masks it asks for.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mel_ct_inner.cuh"
#include "mel_stage.cuh"

namespace {

constexpr int TF = 32;          // frames per block
constexpr int NTHREADS = 512;   // 16 warps
constexpr int NB = CT_NB;       // CT block length (n2 and q range)
constexpr int PLANE = TF * NB;  // floats per A plane, layout [t][n2]
constexpr int MAX_MJ = 4;       // n_mels <= 128

struct Params {
  const float* y;      // [B, L] rows
  const float* scale;  // [B] or nullptr
  const float* win;    // [n_fft] periodic Hann
  const float* C;      // [(R/2+1)*128, 128] folded cos table
  const float* S;      // [(R/2+1)*128, 128] folded sin table
  const float* FBM;    // [(R/2+1)*128, n_mels] merged filterbank
  const float* wr;     // [R, 2] (cos, sin) of 2*pi*j/R
  float* out;          // [B, T, n_mels]
  long long L;
  int T, n_fft, hop, n_mels, R;
  int frame0;  // first frame computed; out[:, t] is frame frame0 + t
  int pad_l;   // zeros before the row in the centre-padded signal
};

// Outer stage for one r: X = A_r @ (C_r - i S_r), power to `ps` [t][q].
template <bool HAS_IM, bool BF16, int ABLATE>
__device__ __forceinline__ void outer_power(const Params& p, int r,
                                            const float* __restrict__ are,
                                            const float* __restrict__ aim,
                                            float* __restrict__ ps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = warp * 2;  // 16 warps x 2 frames = TF
  const int q0 = lane * 4;  // 32 lanes x 4 q = 128
  const float4* Cr = reinterpret_cast<const float4*>(p.C + (size_t)r * NB * NB) + lane;
  const float4* Sr = reinterpret_cast<const float4*>(p.S + (size_t)r * NB * NB) + lane;
  float xr[2][4], xi[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { xr[i][j] = 0.f; xi[i][j] = 0.f; }

#pragma unroll 4
  for (int k = 0; k < NB; ++k) {
    const float4 c4 = __ldg(Cr + k * (NB / 4));
    const float4 s4 = __ldg(Sr + k * (NB / 4));
    const float c[4] = {c4.x, c4.y, c4.z, c4.w};
    const float s[4] = {s4.x, s4.y, s4.z, s4.w};
    const float a[2] = {are[t0 * NB + k], are[(t0 + 1) * NB + k]};
    float b[2] = {0.f, 0.f};
    if (HAS_IM) { b[0] = aim[t0 * NB + k]; b[1] = aim[(t0 + 1) * NB + k]; }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // x = a @ (C - iS): re = a_re C + a_im S, im = a_im C - a_re S
        xr[i][j] = fmaf(a[i], c[j], xr[i][j]);
        xi[i][j] = fmaf(-a[i], s[j], xi[i][j]);
        if (HAS_IM) {
          xr[i][j] = fmaf(b[i], s[j], xr[i][j]);
          xi[i][j] = fmaf(b[i], c[j], xi[i][j]);
        }
      }
  }
  // AB_FB hands the power on as it is (the reference rounds only an operand
  // of the filterbank product)
  constexpr bool RND = BF16 && !(ABLATE & AB_FB);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float pw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pw[j] = rnd<RND>((ABLATE & AB_POWER) ? xr[i][j] + xi[i][j]
                                           : xr[i][j] * xr[i][j] + xi[i][j] * xi[i][j]);
    *reinterpret_cast<float4*>(ps + (t0 + i) * NB + q0) = make_float4(pw[0], pw[1], pw[2], pw[3]);
  }
}

// Merged-filterbank product for one r: acc[t][m] += sum_q ps[t][q] FBM_r[q][m].
template <int ABLATE>
__device__ __forceinline__ void fb_accumulate(const Params& p, int r,
                                              const float* __restrict__ ps,
                                              float acc[2][MAX_MJ]) {
  const int lane = threadIdx.x & 31;
  const int t0 = (threadIdx.x >> 5) * 2;
  if (ABLATE & AB_FB) {
#pragma unroll
    for (int j = 0; j < MAX_MJ; ++j) {
      const int m = lane + 32 * j;
      if (m < p.n_mels) {
        acc[0][j] += ps[t0 * NB + m];
        acc[1][j] += ps[(t0 + 1) * NB + m];
      }
    }
    return;
  }
  const float* fb = p.FBM + (size_t)r * NB * p.n_mels;
  for (int q = 0; q < NB; ++q) {
    const float p0 = ps[t0 * NB + q];
    const float p1 = ps[(t0 + 1) * NB + q];
#pragma unroll
    for (int j = 0; j < MAX_MJ; ++j) {
      const int m = lane + 32 * j;
      if (m < p.n_mels) {
        const float f = __ldg(fb + q * p.n_mels + m);
        acc[0][j] = fmaf(p0, f, acc[0][j]);
        acc[1][j] = fmaf(p1, f, acc[1][j]);
      }
    }
  }
}

// Where the inner stage leaves plane k of its group at frame t: [k][t][n2],
// rounded in the bf16 mode.
template <bool BF16>
struct PlaneStore {
  float* planes;
  int n2;
  __device__ __forceinline__ void operator()(int k, int t, float v) const {
    planes[k * PLANE + t * NB + n2] = rnd<BF16>(v);
  }
};

// One r through outer stage, power and filterbank, with the block barriers
// that separate the A planes, the power tile and the next writer.
template <bool BF16, int ABLATE>
__device__ __forceinline__ void do_r(const Params& p, int r, const float* are,
                                     const float* aim, float* ps,
                                     float acc[2][MAX_MJ]) {
  if (aim != nullptr) outer_power<true, BF16, ABLATE>(p, r, are, aim, ps);
  else outer_power<false, BF16, ABLATE>(p, r, are, nullptr, ps);
  __syncthreads();
  fb_accumulate<ABLATE>(p, r, ps, acc);
  __syncthreads();
}

template <bool BF16, int ABLATE>
__global__ void __launch_bounds__(NTHREADS, 1)
mel_power_ct_kernel(Params p) {
  extern __shared__ float smem[];
  const int n_aud = (TF - 1) * p.hop + p.n_fft;
  float* aud = smem;                    // [n_aud] scaled, clipped samples
  float* planes = aud + ((n_aud + 3) & ~3);  // 4 x [TF][NB] A planes
  float* ps = planes + 4 * PLANE;       // [TF][NB] power

  const int b = blockIdx.y;
  const int t_base = blockIdx.x * TF;
  const float* yrow = p.y + (long long)b * p.L;
  const float s = p.scale != nullptr ? p.scale[b] : -1.f;

  // stage the tile's audio window (scaled and clipped; f32 in both modes:
  // the window and the inner stage run in f32)
  stage_audio<false>(aud, n_aud, yrow, p.L,
                     (long long)(p.frame0 + t_base) * p.hop, p.pad_l, s);
  __syncthreads();

  float acc[2][MAX_MJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MAX_MJ; ++j) acc[i][j] = 0.f;

  const int n2 = threadIdx.x % NB;
  const int tsub = threadIdx.x / NB;  // 4 frame lanes; frame t = tsub + 4i
  const int R = p.R;
  const PlaneStore<BF16> store{planes, n2};

  if (R == 16) {
    float w[16];
#pragma unroll
    for (int n1 = 0; n1 < 16; ++n1) w[n1] = __ldg(p.win + n1 * NB + n2);
    // groups by r0 = r mod 4: {0, 4, 8}, {1, 5}, {2, 6}, {3, 7}
#pragma unroll
    for (int r0 = 0; r0 < 4; ++r0) {
      inner_group16<ABLATE, TF>(r0, aud, p.hop, w, p.wr, n2, tsub, store);
      __syncthreads();
      if (r0 == 0) {
        do_r<BF16, ABLATE>(p, 0, planes, nullptr, ps, acc);
        do_r<BF16, ABLATE>(p, 4, planes + PLANE, planes + 2 * PLANE, ps, acc);
        do_r<BF16, ABLATE>(p, 8, planes + 3 * PLANE, nullptr, ps, acc);
      } else {
        do_r<BF16, ABLATE>(p, r0, planes, planes + PLANE, ps, acc);
        do_r<BF16, ABLATE>(p, r0 + 4, planes + 2 * PLANE, planes + 3 * PLANE, ps, acc);
      }
    }
  } else {
    // literal-weight R-point DFT, one r at a time
    for (int r = 0; r <= R / 2; ++r) {
      const bool has_im = !(r == 0 || 2 * r == R);
      inner_generic<ABLATE, TF>(aud, p.hop, p.win, p.wr, R, r, n2, tsub, store);
      __syncthreads();
      do_r<BF16, ABLATE>(p, r, planes, has_im ? planes + PLANE : nullptr, ps, acc);
    }
  }

  // store, masking the ragged frame edge
  const int lane = threadIdx.x & 31;
  const int t0 = (threadIdx.x >> 5) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = t_base + t0 + i;
    if (t >= p.T) continue;
    float* orow = p.out + ((long long)b * p.T + t) * p.n_mels;
#pragma unroll
    for (int j = 0; j < MAX_MJ; ++j) {
      const int m = lane + 32 * j;
      if (m < p.n_mels) orow[m] = acc[i][j];
    }
  }
}

using Kernel = void (*)(Params);

#ifndef MEL_POWER_CT_ABLATE
#define MEL_POWER_CT_ABLATE 0
#endif

// The instantiation for an ablation mask; nullptr unless it is this library's.
template <bool BF16>
Kernel pick_kernel(int ablate) {
  return ablate == MEL_POWER_CT_ABLATE ? mel_power_ct_kernel<BF16, MEL_POWER_CT_ABLATE> : nullptr;
}

}  // namespace

extern "C" {

// Shared memory (bytes) the kernel needs for (n_fft, hop).
long long mel_power_ct_smem_bytes(int n_fft, int hop) {
  const long long n_aud = (long long)(TF - 1) * hop + n_fft;
  return (((n_aud + 3) & ~3LL) + 5LL * PLANE) * (long long)sizeof(float);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `bf16` != 0 selects the bf16 mode; C/S/FBM must then hold bf16 values.
// `ablate` is a mask of AB_* classes (profiling only); it must be the mask
// the library was built for (-DMEL_POWER_CT_ABLATE=<mask>, 0 without).
int mel_power_ct_launch(const float* y, long long L, const float* scale,
                        const float* C, const float* S, const float* FBM,
                        const float* win, const float* wr, float* out, int B,
                        int T, int frame0, int pad_l, int n_fft, int hop,
                        int n_mels, int bf16, int ablate, void* stream) {
  if (n_fft % NB != 0 || n_fft < 2 * NB || n_mels < 1 || n_mels > 32 * MAX_MJ ||
      B < 1 || T < 1 || B > 65535 || hop < 1 || frame0 < 0 || pad_l < 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.y = y; p.scale = scale; p.win = win; p.C = C; p.S = S; p.FBM = FBM;
  p.wr = wr; p.out = out; p.L = L; p.T = T; p.n_fft = n_fft; p.hop = hop;
  p.n_mels = n_mels; p.R = n_fft / NB; p.frame0 = frame0; p.pad_l = pad_l;
  const long long smem = mel_power_ct_smem_bytes(n_fft, hop);
  Kernel kernel = bf16 ? pick_kernel<true>(ablate) : pick_kernel<false>(ablate);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TF - 1) / TF, B);
  kernel<<<grid, NTHREADS, (size_t)smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
