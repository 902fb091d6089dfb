// Shared by the Cooley-Tukey mel kernels (mel_power_ct.cu,
// mel_power_ct_split.cu): the inner stage
//   A_r[n2] = sum_n1 win[n1*128 + n2] * x[n1*128 + n2] * W_R^(n1*r),  r <= R/2
// over the staged audio window of a tile of TF frames, in f32. Thread
// threadIdx.x covers n2 = threadIdx.x % 128 for the frames tsub + 4i,
// tsub = threadIdx.x / 128: a block of 512 threads covers every frame, one of
// 256 calls it twice, on the window and on the window two frames on. Each
// function hands its planes to `store(k, t,
// value)`, plane k of the group at frame t (and the caller's n2); the caller
// decides where and in which type a plane lives. `store` is a struct with a
// __forceinline__ operator(), not a lambda: everything here must be inlined
// before the compiler's loop passes run. With lambdas nvcc 12.9 peeled and
// unrolled the outer-stage loops that follow in the same kernel less deeply
// (fewer FFMA in the listing) and the exact kernel ran measurably slower.
//
// ABLATE is a mask of op classes dropped for profiling (wrong output by
// design, the reference's `ablate=`); 0 in every serving instantiation:
//   AB_WINDOW  no Hann multiply;
//   AB_INNER   the stage hands block r as a_re and block (r+1) % R as a_im
//              (distinct operands per r, the same real-only pattern);
//   AB_POWER, AB_FB  belong to the outer stage (mel_power_ct.cu).
#pragma once

#include <cuda_runtime.h>

constexpr int CT_NB = 128;  // CT block length (n2 and q range)

enum : int { AB_WINDOW = 1, AB_INNER = 2, AB_POWER = 4, AB_FB = 8 };

// A sample under its window weight (AB_WINDOW: the sample as it is).
template <int ABLATE>
__device__ __forceinline__ float windowed(float w, float x) {
  return (ABLATE & AB_WINDOW) ? x : w * x;
}

// R = 16, radix 4x4: the planes of the r sharing r mod 4 = r0.
//   r0 == 0: k = 0 -> r = 0 (real), 1 / 2 -> r = 4 (re / im), 3 -> r = 8 (real)
//   else:    k = 0 / 1 -> r = r0 (re / im), 2 / 3 -> r = r0 + 4 (re / im)
// `w` holds win[n1*128 + n2] for n1 < 16, `wr` the [16, 2] (cos, sin) table.
// Call it with a literal r0, or from a fully unrolled loop over r0: the
// branches on r0 below are then resolved when the kernel is compiled.
template <int ABLATE, int TF, class Store>
__device__ __forceinline__ void inner_group16(int r0, const float* __restrict__ aud,
                                              int hop, const float (&w)[16],
                                              const float* __restrict__ wr, int n2,
                                              int tsub, Store store) {
  constexpr int NB = CT_NB;
  float tc[4], ts[4];  // twiddle W16^(n0*r0)
#pragma unroll
  for (int n0 = 0; n0 < 4; ++n0) {
    tc[n0] = __ldg(wr + 2 * (n0 * r0));
    ts[n0] = __ldg(wr + 2 * (n0 * r0) + 1);
  }
  for (int i = 0; i < TF / 4; ++i) {
    const int t = tsub + 4 * i;
    const float* x = aud + t * hop + n2;
    if constexpr ((ABLATE & AB_INNER) != 0) {
      const int n1[4] = {r0 == 0 ? 0 : r0, r0 == 0 ? 4 : r0 + 1, r0 == 0 ? 5 : r0 + 4, r0 == 0 ? 8 : r0 + 5};
#pragma unroll
      for (int k = 0; k < 4; ++k) store(k, t, windowed<ABLATE>(w[n1[k]], x[n1[k] * NB]));
    } else {
      float zr[4], zi[4];
#pragma unroll
      for (int n0 = 0; n0 < 4; ++n0) {
        const float x0 = windowed<ABLATE>(w[n0], x[n0 * NB]);
        const float x1 = windowed<ABLATE>(w[4 + n0], x[(4 + n0) * NB]);
        const float x2 = windowed<ABLATE>(w[8 + n0], x[(8 + n0) * NB]);
        const float x3 = windowed<ABLATE>(w[12 + n0], x[(12 + n0) * NB]);
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
      if (r0 == 0) {
        store(0, t, u0r + u1r);  // r = 0 (real)
        store(1, t, v0r + v1i);  // r = 4
        store(2, t, v0i - v1r);
        store(3, t, u0r - u1r);  // r = 8 (real)
      } else {
        store(0, t, u0r + u1r);  // r = r0
        store(1, t, u0i + u1i);
        store(2, t, v0r + v1i);  // r = r0 + 4
        store(3, t, v0i - v1r);
      }
    }
  }
}

// Any R: the literal-weight R-point DFT for one r; plane 0 = re, 1 = im.
template <int ABLATE, int TF, class Store>
__device__ __forceinline__ void inner_generic(const float* __restrict__ aud, int hop,
                                              const float* __restrict__ win,
                                              const float* __restrict__ wr, int R, int r,
                                              int n2, int tsub, Store store) {
  constexpr int NB = CT_NB;
  for (int i = 0; i < TF / 4; ++i) {
    const int t = tsub + 4 * i;
    const float* x = aud + t * hop + n2;
    if constexpr ((ABLATE & AB_INNER) != 0) {
      const int r1 = (r + 1) % R;
      store(0, t, windowed<ABLATE>(__ldg(win + r * NB + n2), x[r * NB]));
      store(1, t, windowed<ABLATE>(__ldg(win + r1 * NB + n2), x[r1 * NB]));
    } else {
      float ar = 0.f, ai = 0.f;
      for (int n1 = 0; n1 < R; ++n1) {
        const int j = (n1 * r) % R;
        const float v = windowed<ABLATE>(__ldg(win + n1 * NB + n2), x[n1 * NB]);
        ar = fmaf(__ldg(wr + 2 * j), v, ar);
        ai = fmaf(-__ldg(wr + 2 * j + 1), v, ai);
      }
      store(0, t, ar);
      store(1, t, ai);
    }
  }
}
