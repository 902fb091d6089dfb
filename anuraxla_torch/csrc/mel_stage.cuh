// Shared by the mel kernels (mel_power_ct_split.cu stages with it,
// mel_power_dense.cu takes STAGE_BATCH): the audio-window stage.
#pragma once

#include <cuda_runtime.h>

// Stage `n_aud` samples of one row into shared memory, starting at sample
// `g0` of the centre-padded signal (the row itself starts `pad_l` samples
// in; 0 for a pre-padded row). Fused RMS normalization: s > 0 ->
// clip(y*s, -1, 1), s <= 0 (the silence sentinel) -> raw. Zeros outside the
// row.
//
// A block computes nothing until its window is staged, and one block fills
// an SM, so the latency of these loads is not hidden by another block. Each
// thread therefore starts STAGE_BATCH independent loads before it uses the
// first (the FP32 Cooley-Tukey kernel, an earlier version of mel_power_ct.cu,
// at B = 1024 on an H100 80GB HBM3 at 700 W: 40.2 ms, against 41.7 ms with one
// load in flight per thread; PERF.md).
constexpr int STAGE_BATCH = 8;

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
      if (i < n_aud) aud[i] = x;
    }
  }
}
