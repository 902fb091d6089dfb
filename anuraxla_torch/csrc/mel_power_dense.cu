// Dense windowed-DFT mel power on Hopper's tensor cores: PCM rows ->
// [B, T, n_mels] f32.
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
// Arithmetic. Every product is of two bf16 values on mma.sync.m16n8k16 with
// f32 accumulators.
//   exact   frames and bases split into hi = bf16(x), lo = bf16(x - hi):
//           re | im = f_hi C_hi + f_hi C_lo + f_lo C_hi; p = re^2 + im^2 in
//           f32, split again; mel += p_hi F_hi + p_hi F_lo + p_lo F_hi.
//   bf16    (the TPU kernel's DEFAULT precision) one pass over bf16(frames),
//           the bf16 bases, bf16(p) and the bf16 filterbank.
// The tensor cores' accumulator truncates at every mma, so no chain is long:
// re | im are summed on them over one K chunk (KSTEPS k16 steps, all passes)
// from zero and the chunks added in round-to-nearest f32; likewise each
// frequency tile's filterbank product into the mel values. One chain over
// K = n_fft (3 x 128 mma at n_fft 2048) read up to 2.35e-5 of a row's max
// from plain f32 on the card, past the exact tier's 2e-5; a model of that
// accumulator (round toward zero after every mma) does the same and falls
// inside with chunks of 4 k16 steps, as the card does (1.24e-5 at worst).
// ops/mel_kernel.py `mel_power_dense_split_plain` is the same arithmetic in
// PyTorch; the host builds the tables (`dense_fragment_tables`): the f32
// bases of a float64 construction, split or rounded, in B-fragment order.
//
// Design. One block owns one row and TF frames (128, else 64, 32 or 16: the
// host picks the largest whose shared memory fits, `dense_tile`); warp w owns
// frames 16w..16w+15. The block stages its audio window ((TF-1)*hop + K
// samples, K = n_fft rounded up to 64, scaled and clipped) once, as bf16
// planes (hi and lo in the exact mode). A fragments are read with ldmatrix
// straight from the window at element offset t*hop + k: hop % 16 == 0 puts
// every frame 32-byte aligned in a plane. Frequencies go in tiles of FT = 64
// bins (the last one holds what is left, a multiple of 16); within a tile the
// K axis streams through a ring of STAGES shared-memory buffers with cp.async,
// KSTEPS k16 steps a buffer, so the loads of chunk i + STAGES - 1 overlap the
// mma's of chunk i. A B fragment is one 16-byte load a lane (C's two words
// and S's two words of the same bins), so a thread's accumulators hold the
// real and imaginary parts of the same bins and it forms the power in
// registers. Within a k16 step the mma's go pass by pass over two groups at
// a time, so that two on one accumulator are four apart: with eight warps an
// SM the mma's latency shows, and the three passes of one accumulator back to
// back took row 4's shape 26.6 ms against 21.2 (chip_smoke.py, PERF.md). Two
// n8 accumulator tiles are the A layout of one k16 step, so the power feeds a
// second mma against the filterbank's fragments (read through the read-only
// cache) without leaving registers; the mel values of a warp's 16 frames
// accumulate in registers over every tile (8 or 16 mel tiles of registers:
// n_mels <= 64 or <= 128). The store masks the ragged frame edge and the
// padded mel columns; a warp whose frames all lie past the end computes
// nothing.
//
// What this does about the FP32 kernel it replaces (an earlier version of
// this file: 32 frames a block, both 9.4 MB bases read from L2 by every
// block through __ldg, FFMA): with 128 frames a block each base tile
// comes from L2 once for 128 frames (17.0 MB of exact-mode fragments a block,
// ~35 GB a batch instead of ~155 at 256 rows x 1001 frames), and it goes to
// shared memory once for eight warps. Its time no longer follows where the
// allocator put the tables (21.1-21.3 ms over six placements, against
// 122-133 ms for the FP32 kernel). ldmatrix reads the window's rows 2*hop
// bytes apart: 2-way bank conflicts at hop 240 and 80, 4-way at hop % 64 ==
// 32, 8-way at hop % 64 == 0; `chip_smoke.py --dense-checkpoints` measured
// 13.6, 15.1 and 18.1 ms for 2-, 4- and 8-way on the same frames.
//
// Bound on an H100 SXM. The function's least work is that of
// mel_power_ct.cu (~64 kFLOP a frame at n_fft 2048); chip_smoke.py bounds
// this kernel at the bf16 tensor-core peak (989 TFLOP/s), the exact mode's
// work counted once for each of its three passes, against the function's
// bytes (rows, tables, output): at n_fft 2048 / hop 240, 256 rows x 1001
// frames, that is 0.050 ms of work against 0.093 ms of bytes. The dense form
// itself does 2 * 2 * K * n_freq_pad + 2 * n_freq_pad * 8 ceil(n_mels/8)
// = 8.65 MFLOP a frame a pass there (n_freq_pad = 1040), ~135x that work:
// 6.65 TFLOP in the exact mode for that batch, 6.7 ms at the bf16 peak; the
// symmetry fold and a fast algorithm for n_fft are the next steps (ROADMAP).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 21.2 ms
// for that batch (314 TFLOP/s of the form; one torch.stft call 7.0 ms), 80.8
// ms at B = 1024, and 10.7 ms in the bf16 mode over the fast tier's 192
// frames of 1024 rows (159 TFLOP/s; torch.stft 5.2 ms).
//
// ptxas (nvcc 12.9, sm_90a), as ops/_build.py keeps it beside the library:
// 162-236 registers by instantiation, 1 barrier, 0 bytes stack frame, 0
// bytes spill stores, 0 bytes spill loads; one block of 128 frames an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mel_stage.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int FT = 64;              // bins of a frequency tile
constexpr int GROUPS = FT / 8;      // n8 groups of a tile
constexpr int GSET = 2;             // groups whose B fragments are held at once
constexpr int KC = 64;              // the bases' rows are a multiple of this
constexpr int MAX_MEL_TILES = 16;   // n_mels <= 128 (MEL_TILES 8: n_mels <= 64)
constexpr int MAX_THREADS = 256;    // TF = 128: 8 warps

struct Params {
  const float* y;      // [B, L] rows
  const float* scale;  // [B] or nullptr
  const uint4* basis;  // fragment tiles (mel_kernel.py dense_fragment_tables)
  const uint2* fb;     // [n_freq_pad/16, mel tiles, 32 lanes, parts] fragments
  float* out;          // [B, T, n_mels]
  long long L;
  int T, hop, n_mels, k_pad, n_freq_pad;
  int frame0;  // first frame computed; out[:, t] is frame frame0 + t
  int pad_l;   // zeros before the row in the centre-padded signal
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

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
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Two f32 values as one bf16x2 word, the first in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage `n_aud` samples of one row from sample `g0` of the centre-padded
// signal as bf16 planes: hi = bf16(v) and, EXACT, lo = bf16(v - hi), with the
// fused RMS scale and the zeros outside the row of mel_stage.cuh's
// stage_audio (STAGE_BATCH loads in flight a thread).
template <bool EXACT>
__device__ __forceinline__ void stage_planes(bf16* __restrict__ hi, bf16* __restrict__ lo, int n_aud,
                                             const float* __restrict__ yrow, long long L,
                                             long long g0, int pad_l, float s) {
  const long long base = g0 - pad_l;
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
      if (i < n_aud) {
        const bf16 h = __float2bfloat16_rn(x);
        hi[i] = h;
        if (EXACT) lo[i] = __float2bfloat16_rn(x - __bfloat162float(h));
      }
    }
  }
}

template <bool EXACT, int KSTEPS, int STAGES, int MEL_TILES>
__global__ void __launch_bounds__(MAX_THREADS, 1)
mel_power_dense_kernel(Params p) {
  constexpr int P = EXACT ? 2 : 1;                   // parts of an operand: hi, lo
  constexpr int STAGE_U4 = KSTEPS * GROUPS * P * 32;  // uint4 a ring buffer
  extern __shared__ uint4 smem[];
  const int TF = blockDim.x / 2;  // 16 frames a warp
  const int n_aud = (TF - 1) * p.hop + p.k_pad;
  uint4* ring = smem;
  bf16* hi = reinterpret_cast<bf16*>(ring + STAGES * STAGE_U4);
  bf16* lo = hi + round_up(n_aud, 8);

  const int b = blockIdx.y;
  const int t_base = blockIdx.x * TF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const bool active = t_base + 16 * warp < p.T;  // the same for a whole warp

  const int n_chunks = p.k_pad / (16 * KSTEPS);
  const int n_tiles = (p.n_freq_pad + FT - 1) / FT;
  const int n_iter = n_tiles * n_chunks;
  const int n_mel_tiles = (p.n_mels + 7) / 8;

  // chunk i = (tile, K chunk) of the bases -> ring buffer `slot`
  auto issue = [&](int i, int slot) {
    const int tile = i / n_chunks, chunk = i % n_chunks;
    const int groups = min(GROUPS, (p.n_freq_pad - tile * FT) / 8);
    const int n = KSTEPS * groups * P * 32;
    const uint4* src = p.basis + (size_t)tile * (p.k_pad / 16) * GROUPS * P * 32 + (size_t)chunk * n;
    uint4* dst = ring + slot * STAGE_U4;
    for (int u = threadIdx.x; u < n; u += blockDim.x) cp_async16(dst + u, src + u);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_iter) issue(s, s);
    cp_async_commit();
  }

  const float sc = p.scale != nullptr ? p.scale[b] : -1.f;
  stage_planes<EXACT>(hi, lo, n_aud, p.y + (long long)b * p.L, p.L,
                      (long long)(p.frame0 + t_base) * p.hop, p.pad_l, sc);

  // this lane's ldmatrix row address: frame 16 warp + (lane & 15), column (lane >> 4) * 8
  const int a_off = ((16 * warp + (lane & 15)) * p.hop + (lane >> 4) * 8) * (int)sizeof(bf16);
  const uint32_t a_hi = (uint32_t)__cvta_generic_to_shared(hi) + a_off;
  const uint32_t a_lo = (uint32_t)__cvta_generic_to_shared(lo) + a_off;

  // re/im of a K chunk (summed on the tensor cores from zero), their running
  // sums over the chunks (IEEE f32 adds), and the mel values of 16 frames
  float re[GROUPS][4], im[GROUPS][4], sre[GROUPS][4], sim[GROUPS][4], mel[MEL_TILES][4];
#pragma unroll
  for (int j = 0; j < GROUPS; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) sre[j][r] = sim[j][r] = 0.f;
#pragma unroll
  for (int n = 0; n < MEL_TILES; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) mel[n][r] = 0.f;

  for (int i = 0; i < n_iter; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk i has landed; every warp is done with chunk i - 1's buffer
    if (i + STAGES - 1 < n_iter) issue(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    const int tile = i / n_chunks, chunk = i % n_chunks;
    const int groups = min(GROUPS, (p.n_freq_pad - tile * FT) / 8);
    if (!active) continue;

    // The tensor cores' f32 accumulator truncates at every mma (see the note
    // at the head): a chunk is summed from zero and added to the running sums
    // in round-to-nearest f32.
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) re[j][r] = im[j][r] = 0.f;
    const uint4* st = ring + (i % STAGES) * STAGE_U4 + lane;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint32_t k_bytes = (uint32_t)((chunk * KSTEPS + ks) * 16 * sizeof(bf16));
      uint32_t ah[4], al[4];
      ldmatrix_x4(ah, a_hi + k_bytes);
      if (EXACT) ldmatrix_x4(al, a_lo + k_bytes);
      // GSET groups at a time, pass by pass, so that two mma's on one
      // accumulator are 2 * GSET mma's apart
#pragma unroll
      for (int j0 = 0; j0 < GROUPS; j0 += GSET) {
        uint4 bh[GSET], bl[GSET];
#pragma unroll
        for (int j = j0; j < j0 + GSET; ++j) {
          if (j >= groups) continue;
          bh[j - j0] = st[((ks * groups + j) * P) * 32];
          if (EXACT) bl[j - j0] = st[((ks * groups + j) * P + 1) * 32];
        }
#pragma unroll
        for (int pass = 0; pass < (EXACT ? 3 : 1); ++pass)
#pragma unroll
          for (int j = j0; j < j0 + GSET; ++j) {
            if (j >= groups) continue;
            const uint4 b = pass == 1 ? bl[j - j0] : bh[j - j0];  // hi.hi, hi.lo, lo.hi
            const uint32_t(&a)[4] = pass == 2 ? al : ah;
            mma_bf16(re[j], a, b.x, b.y);
            mma_bf16(im[j], a, b.z, b.w);
          }
      }
    }
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sre[j][r] = __fadd_rn(sre[j][r], re[j][r]);
        sim[j][r] = __fadd_rn(sim[j][r], im[j][r]);
      }
    if (chunk != n_chunks - 1) continue;

    // the tile's last chunk: power in registers, then its filterbank product.
    // Sum register r of group j holds bin 8j + 2c + (r & 1) of frame
    // g + 8 (r >> 1); groups 2q, 2q + 1 are the A fragment of k16 step q.
    uint32_t ph[GROUPS / 2][4], pl[GROUPS / 2][4];
#pragma unroll
    for (int q = 0; q < GROUPS / 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          float pw[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = sre[2 * q + h][2 * row + e], y = sim[2 * q + h][2 * row + e];
            pw[e] = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
          }
          const uint32_t w = pack_bf16(pw[0], pw[1]);
          ph[q][2 * h + row] = w;
          if (EXACT) {  // the lo half is formed in f32 from the rounded hi half
            const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&w);
            pl[q][2 * h + row] = pack_bf16(pw[0] - __low2float(hv), pw[1] - __high2float(hv));
          }
        }
    // each mel tile: the tile's contribution summed from zero, then added
    const uint2* fbp = p.fb + ((size_t)tile * (FT / 16) * n_mel_tiles * 32 + lane) * P;
#pragma unroll
    for (int n = 0; n < MEL_TILES; ++n) {
      if (n >= n_mel_tiles) continue;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < GROUPS / 2; ++q) {
        if (2 * q >= groups) continue;
        const uint2* f = fbp + ((size_t)q * n_mel_tiles + n) * 32 * P;
        if (EXACT) {
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(f));
          mma_bf16(d, ph[q], w.x, w.y);
          mma_bf16(d, ph[q], w.z, w.w);
          mma_bf16(d, pl[q], w.x, w.y);
        } else {
          const uint2 w = __ldg(f);
          mma_bf16(d, ph[q], w.x, w.y);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) mel[n][r] = __fadd_rn(mel[n][r], d[r]);
    }
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) sre[j][r] = sim[j][r] = 0.f;
  }
  cp_async_wait<0>();

  if (!active) return;
  // store, masking the ragged frame edge and the padded mel columns
#pragma unroll
  for (int n = 0; n < MEL_TILES; ++n) {
    if (n >= n_mel_tiles) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = t_base + 16 * warp + g + 8 * (r >> 1);
      const int m = 8 * n + 2 * c + (r & 1);
      if (t < p.T && m < p.n_mels) p.out[((long long)b * p.T + t) * p.n_mels + m] = mel[n][r];
    }
  }
}

// (KSTEPS, STAGES) of the ring: the wide one, and the small one that keeps
// configs with a long audio window within shared memory; the mel registers of
// up to 64 mels, or of up to 128
template <bool EXACT, int MEL_TILES>
cudaError_t launch(const Params& p, dim3 grid, int threads, int ksteps, int stages, long long smem,
                   cudaStream_t stream) {
  void (*kernel)(Params);
  if (ksteps == 4 && stages == 3) kernel = mel_power_dense_kernel<EXACT, 4, 3, MEL_TILES>;
  else if (ksteps == 1 && stages == 2) kernel = mel_power_dense_kernel<EXACT, 1, 2, MEL_TILES>;
  else return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, (size_t)smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory (bytes) the kernel needs for (n_fft, hop) with `tf` frames a
// block and a ring of `stages` buffers of `ksteps` k16 steps; mirrored by
// ops/mel_kernel.py `dense_smem_bytes`.
long long mel_power_dense_smem_bytes(int n_fft, int hop, int tf, int ksteps, int stages, int bf16) {
  const long long parts = bf16 ? 1 : 2;
  const long long n_aud = (long long)(tf - 1) * hop + round_up(n_fft, KC);
  return (long long)stages * ksteps * GROUPS * parts * 512 + parts * 2 * ((n_aud + 7) / 8 * 8);
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `basis` / `fb` are the fragment tables of the mode (`bf16` != 0: the bf16
// mode's), as ops/mel_kernel.py `dense_fragment_tables` builds them.
int mel_power_dense_launch(const float* y, long long L, const float* scale, const void* basis,
                           const void* fb, float* out, int B, int T, int frame0, int pad_l,
                           int n_fft, int hop, int n_mels, int tf, int ksteps, int stages,
                           int bf16, void* stream) {
  if (n_fft < 2 || n_mels < 1 || n_mels > 8 * MAX_MEL_TILES || B < 1 || T < 1 || B > 65535 ||
      hop < 1 || hop % 16 != 0 || frame0 < 0 || pad_l < 0 ||
      !(tf == 16 || tf == 32 || tf == 64 || tf == 128))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.y = y; p.scale = scale; p.basis = static_cast<const uint4*>(basis);
  p.fb = static_cast<const uint2*>(fb); p.out = out; p.L = L;
  p.T = T; p.hop = hop; p.n_mels = n_mels; p.k_pad = round_up(n_fft, KC);
  p.n_freq_pad = round_up(n_fft / 2 + 1, 16); p.frame0 = frame0; p.pad_l = pad_l;
  const long long smem = mel_power_dense_smem_bytes(n_fft, hop, tf, ksteps, stages, bf16);
  const dim3 grid((T + tf - 1) / tf, B);
  const int threads = 2 * tf;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (n_mels <= 64)
    err = bf16 ? launch<false, 8>(p, grid, threads, ksteps, stages, smem, st)
               : launch<true, 8>(p, grid, threads, ksteps, stages, smem, st);
  else
    err = bf16 ? launch<false, MAX_MEL_TILES>(p, grid, threads, ksteps, stages, smem, st)
               : launch<true, MAX_MEL_TILES>(p, grid, threads, ksteps, stages, smem, st);
  return (int)err;
}

}  // extern "C"
