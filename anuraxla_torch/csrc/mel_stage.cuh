// Shared by the mel kernels (mel_power_ct.cu, mel_power_dense.cu): the bf16
// rounding point and the audio-window stage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The bf16 modes keep every value in f32 registers and shared memory but
// round it to bf16 (nearest even) wherever the TPU kernel casts an operand
// to bf16. A product of two such values is exact in f32 and the sums are
// f32, so an FFMA on rounded operands is the TPU's bf16 pass with f32
// accumulation.
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// Stage `n_aud` samples of one row into shared memory, starting at sample
// `g0` of the centre-padded signal (the row itself starts `pad_l` samples
// in; 0 for a pre-padded row). Fused RMS normalization: s > 0 ->
// clip(y*s, -1, 1), s <= 0 (the silence sentinel) -> raw. Zeros outside the
// row. ROUND rounds the staged sample to bf16 (the dense kernel's bf16 mode,
// where the frame itself is a product operand).
//
// A block computes nothing until its window is staged, and one block fills
// an SM, so the latency of these loads is not hidden by another block. Each
// thread therefore starts STAGE_BATCH independent loads before it uses the
// first (the Cooley-Tukey kernel at B = 1024 on an H100 80GB HBM3 at 700 W:
// 40.2 ms, against 41.7 ms with one load in flight per thread; PERF.md).
constexpr int STAGE_BATCH = 8;

template <bool ROUND>
__device__ __forceinline__ void stage_audio(float* __restrict__ aud, int n_aud,
                                            const float* __restrict__ yrow,
                                            long long L, long long g0, int pad_l,
                                            float s) {
  const long long base = g0 - pad_l;  // index into the row of staged sample 0
  const int step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n_aud; i0 += STAGE_BATCH * step) {
    float v[STAGE_BATCH];
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int i = i0 + u * step;
      const long long g = base + i;
      v[u] = (i < n_aud && g >= 0 && g < L) ? yrow[g] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int i = i0 + u * step;
      float x = v[u];
      if (s > 0.f) x = fminf(fmaxf(x * s, -1.f), 1.f);
      if (i < n_aud) aud[i] = rnd<ROUND>(x);
    }
  }
}
