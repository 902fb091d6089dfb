// Dense windowed-DFT mel power on Hopper: PCM rows -> [B, T, n_mels] f32.
//
// Replaces the TPU kernel `_mel_power_kernel`
// (anuraxla/ops/pallas_frontend.py:66), as `mel_power_pallas` drives it from
// its dense branch (:1314-1378): the kernel for hop % 16 == 0 configs that
// the Cooley-Tukey kernel cannot take, and for any n_fft.
//
//   mel[b, t, :] = ((f_t @ C)^2 + (f_t @ S)^2) @ FB
//   f_t[n] = v[b, (t0+t)*hop + n],  v = clip(y*s, -1, 1) if s > 0 else y
//
// over the centre-padded signal, with the periodic Hann window folded into
// the bases C[n,k] = w[n] cos(2 pi k n / n_fft), S[n,k] = -w[n] sin(...),
// k < n_freq = n_fft/2 + 1.
//
// What the TPU kernel's shape answered, and what stands here instead:
//   - its third grid axis walks frequency tiles in order and accumulates
//     into the output block; here that axis is a loop inside the block and
//     the mel accumulator lives in registers;
//   - its 8-row hop-shifted copy of every signal (8x the audio in HBM) and
//     the CHUNK_B map that bounds that copy exist because Mosaic cannot
//     slice below a sublane; here a frame is read at any offset of the
//     staged window, so the rows are read as they are, once.
//
// Design. One block of 512 threads owns one row and a tile of TF = 32
// frames. It stages the tile's audio window ((TF-1)*hop + n_fft samples,
// scaled and clipped) in shared memory once. For each tile of FT = 128
// frequencies a thread accumulates re/im of 2 frames x 4 frequencies over
// the n_fft samples (FP32 FFMA; the bases are read through the read-only
// cache, 16 bytes a thread, and are shared by every block: 2 x 9.4 MB at
// n_fft 2048, resident in L2), writes the power tile to shared memory, and
// adds its filterbank product to the mel accumulator in registers. The host
// zero-pads the frequency axis of C, S and FB to a multiple of FT, so a
// tile needs no mask (the padding contributes exact zeros). The ragged frame
// edge is masked at the store.
//
// Exactness. exact mode: plain FP32 FFMA, f32 bases from a float64
// construction (the TPU kernel's HIGHEST). bf16 mode (BF16 = true, the TPU
// kernel's DEFAULT precision): the frames are rounded to bf16 when staged,
// the power when written, and the caller passes bases and filterbank rounded
// to bf16; products of two bf16 values are exact in f32, sums are f32.
//
// Bound on an H100 SXM. The function is the one mel_power_ct.cu computes,
// so its least work is the same (a real FFT, the window, the power, the
// filterbank's nonzero weights: ~64 kFLOP a frame at n_fft 2048). This
// kernel's dense form does 2 * 2 * n_fft * n_freq_pad + 2 * n_freq_pad *
// n_mels = ~9.6 MFLOP a frame there, ~150x that work, at the rate the FFMA
// pipe sustains: it is the reference-grade fallback, not a fast path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mel_stage.cuh"

namespace {

constexpr int TF = 32;         // frames per block
constexpr int NTHREADS = 512;  // 16 warps x 2 frames
constexpr int FT = 128;        // frequencies per tile: 32 lanes x 4
constexpr int MAX_MJ = 4;      // n_mels <= 128

struct Params {
  const float* y;      // [B, L] rows
  const float* scale;  // [B] or nullptr
  const float* C;      // [n_fft, n_freq_pad] windowed cos bases
  const float* S;      // [n_fft, n_freq_pad] windowed -sin bases
  const float* FB;     // [n_freq_pad, n_mels] filterbank
  float* out;          // [B, T, n_mels]
  long long L;
  int T, n_fft, hop, n_mels, n_freq_pad;
  int frame0;  // first frame computed; out[:, t] is frame frame0 + t
  int pad_l;   // zeros before the row in the centre-padded signal
};

template <bool BF16>
__global__ void __launch_bounds__(NTHREADS, 1)
mel_power_dense_kernel(Params p) {
  extern __shared__ float smem[];
  const int n_aud = (TF - 1) * p.hop + p.n_fft;
  float* aud = smem;                     // [n_aud] scaled, clipped samples
  float* ps = aud + ((n_aud + 3) & ~3);  // [TF][FT] power tile

  const int b = blockIdx.y;
  const int t_base = blockIdx.x * TF;
  const float s = p.scale != nullptr ? p.scale[b] : -1.f;
  stage_audio<BF16>(aud, n_aud, p.y + (long long)b * p.L, p.L,
                    (long long)(p.frame0 + t_base) * p.hop, p.pad_l, s);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int t0 = (threadIdx.x >> 5) * 2;
  const int q0 = lane * 4;
  const float* a0 = aud + t0 * p.hop;
  const float* a1 = a0 + p.hop;
  const int stride4 = p.n_freq_pad / 4;

  float acc[2][MAX_MJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MAX_MJ; ++j) acc[i][j] = 0.f;

  for (int f0 = 0; f0 < p.n_freq_pad; f0 += FT) {
    const float4* Cf = reinterpret_cast<const float4*>(p.C + f0) + lane;
    const float4* Sf = reinterpret_cast<const float4*>(p.S + f0) + lane;
    float xr[2][4], xi[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) { xr[i][j] = 0.f; xi[i][j] = 0.f; }

#pragma unroll 4
    for (int n = 0; n < p.n_fft; ++n) {
      const float4 c4 = __ldg(Cf + (size_t)n * stride4);
      const float4 s4 = __ldg(Sf + (size_t)n * stride4);
      const float c[4] = {c4.x, c4.y, c4.z, c4.w};
      const float sn[4] = {s4.x, s4.y, s4.z, s4.w};
      const float a[2] = {a0[n], a1[n]};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          xr[i][j] = fmaf(a[i], c[j], xr[i][j]);
          xi[i][j] = fmaf(a[i], sn[j], xi[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float4 pw;
      pw.x = rnd<BF16>(xr[i][0] * xr[i][0] + xi[i][0] * xi[i][0]);
      pw.y = rnd<BF16>(xr[i][1] * xr[i][1] + xi[i][1] * xi[i][1]);
      pw.z = rnd<BF16>(xr[i][2] * xr[i][2] + xi[i][2] * xi[i][2]);
      pw.w = rnd<BF16>(xr[i][3] * xr[i][3] + xi[i][3] * xi[i][3]);
      *reinterpret_cast<float4*>(ps + (t0 + i) * FT + q0) = pw;
    }
    __syncthreads();

    // filterbank product of this tile: acc[t][m] += sum_q ps[t][q] FB[f0+q][m]
    const float* fb = p.FB + (size_t)f0 * p.n_mels;
    for (int q = 0; q < FT; ++q) {
      const float p0 = ps[t0 * FT + q];
      const float p1 = ps[(t0 + 1) * FT + q];
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
    __syncthreads();
  }

  // store, masking the ragged frame edge
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
long long mel_power_dense_smem_bytes(int n_fft, int hop) {
  const long long n_aud = (long long)(TF - 1) * hop + n_fft;
  return (((n_aud + 3) & ~3LL) + (long long)TF * FT) * (long long)sizeof(float);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// C/S are [n_fft, n_freq_pad] and FB [n_freq_pad, n_mels], n_freq_pad a
// multiple of 128 with zeros past n_fft/2 + 1. `bf16` != 0 selects the bf16
// mode; C/S/FB must then hold bf16 values.
int mel_power_dense_launch(const float* y, long long L, const float* scale,
                           const float* C, const float* S, const float* FB,
                           float* out, int B, int T, int frame0, int pad_l,
                           int n_fft, int hop, int n_mels, int n_freq_pad,
                           int bf16, void* stream) {
  if (n_fft < 2 || n_freq_pad % FT != 0 || n_freq_pad < n_fft / 2 + 1 ||
      n_mels < 1 || n_mels > 32 * MAX_MJ || B < 1 || T < 1 || B > 65535 ||
      hop < 1 || frame0 < 0 || pad_l < 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.y = y; p.scale = scale; p.C = C; p.S = S; p.FB = FB; p.out = out; p.L = L;
  p.T = T; p.n_fft = n_fft; p.hop = hop; p.n_mels = n_mels;
  p.n_freq_pad = n_freq_pad; p.frame0 = frame0; p.pad_l = pad_l;
  const long long smem = mel_power_dense_smem_bytes(n_fft, hop);
  auto kernel = bf16 ? mel_power_dense_kernel<true> : mel_power_dense_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TF - 1) / TF, B);
  kernel<<<grid, NTHREADS, (size_t)smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
