// Fused mel power on Hopper: pre-padded PCM rows -> [B, T, n_mels] f32.
//
// Replaces the TPU kernel `_mel_power_ctp_kernel`
// (anuraxla/ops/pallas_frontend.py:567) in its exact mode, as
// `mel_power_pallas` drives it from its phase branch (:1030-1172). It ports
// what that kernel computes, not its blocking:
//
//   mel[b, t, :] = sum_k |DFT_n(hann[n] * v[b, t*hop + n])[k]|^2 * fb[k, :]
//   v = clip(y * s, -1, 1) if s > 0 else y     (fused RMS normalization)
//
// with the Cooley-Tukey split n = n1*128 + n2 (n1 < R = n_fft/128) and
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TF = 32;          // frames per block
constexpr int NTHREADS = 512;   // 16 warps
constexpr int NB = 128;         // CT block length (n2 and q range)
constexpr int PLANE = TF * NB;  // floats per A plane, layout [t][n2]
constexpr int MAX_MJ = 4;       // n_mels <= 128

struct Params {
  const float* y;      // [B, L] pre-padded rows
  const float* scale;  // [B] or nullptr
  const float* win;    // [n_fft] periodic Hann
  const float* C;      // [(R/2+1)*128, 128] folded cos table
  const float* S;      // [(R/2+1)*128, 128] folded sin table
  const float* FBM;    // [(R/2+1)*128, n_mels] merged filterbank
  const float* wr;     // [R, 2] (cos, sin) of 2*pi*j/R
  float* out;          // [B, T, n_mels]
  long long L;
  int T, n_fft, hop, n_mels, R;
};

// Outer stage for one r: X = A_r @ (C_r - i S_r), power to `ps` [t][q].
template <bool HAS_IM>
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
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float4 pw;
    pw.x = xr[i][0] * xr[i][0] + xi[i][0] * xi[i][0];
    pw.y = xr[i][1] * xr[i][1] + xi[i][1] * xi[i][1];
    pw.z = xr[i][2] * xr[i][2] + xi[i][2] * xi[i][2];
    pw.w = xr[i][3] * xr[i][3] + xi[i][3] * xi[i][3];
    *reinterpret_cast<float4*>(ps + (t0 + i) * NB + q0) = pw;
  }
}

// Merged-filterbank product for one r: acc[t][m] += sum_q ps[t][q] FBM_r[q][m].
__device__ __forceinline__ void fb_accumulate(const Params& p, int r,
                                              const float* __restrict__ ps,
                                              float acc[2][MAX_MJ]) {
  const int lane = threadIdx.x & 31;
  const int t0 = (threadIdx.x >> 5) * 2;
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

// One r through outer stage, power and filterbank, with the block barriers
// that separate the A planes, the power tile and the next writer.
__device__ __forceinline__ void do_r(const Params& p, int r, const float* are,
                                     const float* aim, float* ps,
                                     float acc[2][MAX_MJ]) {
  if (aim != nullptr) outer_power<true>(p, r, are, aim, ps);
  else outer_power<false>(p, r, are, nullptr, ps);
  __syncthreads();
  fb_accumulate(p, r, ps, acc);
  __syncthreads();
}

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

  // stage the tile's audio window; fused RMS: s > 0 -> clip(y*s, -1, 1),
  // s <= 0 (silence sentinel) -> raw; zeros past the row end
  const long long g0 = (long long)t_base * p.hop;
  for (int i = threadIdx.x; i < n_aud; i += NTHREADS) {
    const long long g = g0 + i;
    float v = g < p.L ? yrow[g] : 0.f;
    if (s > 0.f) v = fminf(fmaxf(v * s, -1.f), 1.f);
    aud[i] = v;
  }
  __syncthreads();

  float acc[2][MAX_MJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MAX_MJ; ++j) acc[i][j] = 0.f;

  const int n2 = threadIdx.x % NB;
  const int tsub = threadIdx.x / NB;  // 4 frame lanes; frame t = tsub + 4i
  const int R = p.R;

  if (R == 16) {
    float w[16];
#pragma unroll
    for (int n1 = 0; n1 < 16; ++n1) w[n1] = __ldg(p.win + n1 * NB + n2);
    // groups by r0 = r mod 4: {0, 4, 8}, {1, 5}, {2, 6}, {3, 7}
#pragma unroll
    for (int r0 = 0; r0 < 4; ++r0) {
      float tc[4], ts[4];  // twiddle W16^(n0*r0)
#pragma unroll
      for (int n0 = 0; n0 < 4; ++n0) {
        tc[n0] = __ldg(p.wr + 2 * (n0 * r0));
        ts[n0] = __ldg(p.wr + 2 * (n0 * r0) + 1);
      }
      for (int i = 0; i < TF / 4; ++i) {
        const int t = tsub + 4 * i;
        const float* x = aud + t * p.hop + n2;
        float zr[4], zi[4];
#pragma unroll
        for (int n0 = 0; n0 < 4; ++n0) {
          const float x0 = w[n0] * x[n0 * NB];
          const float x1 = w[4 + n0] * x[(4 + n0) * NB];
          const float x2 = w[8 + n0] * x[(8 + n0) * NB];
          const float x3 = w[12 + n0] * x[(12 + n0) * NB];
          const float e0 = x0 + x2, e1 = x1 + x3, d0 = x0 - x2, d1 = x1 - x3;
          // 4-point DFT over n1' at r0 (W4 = 1, -i, -1, i)
          float gr, gi;
          if (r0 == 0) { gr = e0 + e1; gi = 0.f; }
          else if (r0 == 1) { gr = d0; gi = -d1; }
          else if (r0 == 2) { gr = e0 - e1; gi = 0.f; }
          else { gr = d0; gi = d1; }
          // times W16^(n0 r0) = c - i s
          zr[n0] = gr * tc[n0] + gi * ts[n0];
          zi[n0] = gi * tc[n0] - gr * ts[n0];
        }
        const float u0r = zr[0] + zr[2], u0i = zi[0] + zi[2];
        const float u1r = zr[1] + zr[3], u1i = zi[1] + zi[3];
        const float v0r = zr[0] - zr[2], v0i = zi[0] - zi[2];
        const float v1r = zr[1] - zr[3], v1i = zi[1] - zi[3];
        const int o = t * NB + n2;
        if (r0 == 0) {
          planes[0 * PLANE + o] = u0r + u1r;  // r = 0 (real)
          planes[1 * PLANE + o] = v0r + v1i;  // r = 4
          planes[2 * PLANE + o] = v0i - v1r;
          planes[3 * PLANE + o] = u0r - u1r;  // r = 8 (real)
        } else {
          planes[0 * PLANE + o] = u0r + u1r;  // r = r0
          planes[1 * PLANE + o] = u0i + u1i;
          planes[2 * PLANE + o] = v0r + v1i;  // r = r0 + 4
          planes[3 * PLANE + o] = v0i - v1r;
        }
      }
      __syncthreads();
      if (r0 == 0) {
        do_r(p, 0, planes, nullptr, ps, acc);
        do_r(p, 4, planes + PLANE, planes + 2 * PLANE, ps, acc);
        do_r(p, 8, planes + 3 * PLANE, nullptr, ps, acc);
      } else {
        do_r(p, r0, planes, planes + PLANE, ps, acc);
        do_r(p, r0 + 4, planes + 2 * PLANE, planes + 3 * PLANE, ps, acc);
      }
    }
  } else {
    // literal-weight R-point DFT, one r at a time
    for (int r = 0; r <= R / 2; ++r) {
      const bool has_im = !(r == 0 || 2 * r == R);
      for (int i = 0; i < TF / 4; ++i) {
        const int t = tsub + 4 * i;
        const float* x = aud + t * p.hop + n2;
        float ar = 0.f, ai = 0.f;
        for (int n1 = 0; n1 < R; ++n1) {
          const int j = (n1 * r) % R;
          const float v = __ldg(p.win + n1 * NB + n2) * x[n1 * NB];
          ar = fmaf(__ldg(p.wr + 2 * j), v, ar);
          ai = fmaf(-__ldg(p.wr + 2 * j + 1), v, ai);
        }
        planes[t * NB + n2] = ar;
        planes[PLANE + t * NB + n2] = ai;
      }
      __syncthreads();
      do_r(p, r, planes, has_im ? planes + PLANE : nullptr, ps, acc);
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

}  // namespace

extern "C" {

// Shared memory (bytes) the kernel needs for (n_fft, hop).
long long mel_power_ct_smem_bytes(int n_fft, int hop) {
  const long long n_aud = (long long)(TF - 1) * hop + n_fft;
  return (((n_aud + 3) & ~3LL) + 5LL * PLANE) * (long long)sizeof(float);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int mel_power_ct_launch(const float* y, long long L, const float* scale,
                        const float* win, const float* C, const float* S,
                        const float* FBM, const float* wr, float* out, int B,
                        int T, int n_fft, int hop, int n_mels, void* stream) {
  if (n_fft % NB != 0 || n_fft < 2 * NB || n_mels < 1 || n_mels > 32 * MAX_MJ ||
      B < 1 || T < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.y = y; p.scale = scale; p.win = win; p.C = C; p.S = S; p.FBM = FBM;
  p.wr = wr; p.out = out; p.L = L; p.T = T; p.n_fft = n_fft; p.hop = hop;
  p.n_mels = n_mels; p.R = n_fft / NB;
  const long long smem = mel_power_ct_smem_bytes(n_fft, hop);
  cudaError_t err = cudaFuncSetAttribute(
      mel_power_ct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TF - 1) / TF, B);
  mel_power_ct_kernel<<<grid, NTHREADS, (size_t)smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
