// Int8 contractions of the quantized serving encoder on Hopper's integer
// tensor cores: an implicit-GEMM 3x3 conv over NHWC input and a dense layer,
// each with int32 sums and a float epilogue, the activations' int8 codes
// formed as the operand is loaded.
//
// Replaces the int8 contractions of anuraxla/models/quant.py, which are not
// Pallas kernels: `_int8_conv` (:204, lax.conv_general_dilated on int8
// operands, preferred_element_type=int32) and `_int8_dot` (:198,
// lax.dot_general likewise), with the activation quantization before them
// (`_quant_x`, :194) and the dequantization after them (:243-246, :256).
// PyTorch has no int8 convolution on CUDA, and its int8 matrix product
// (torch._int_mm) takes only more than 16 rows and K, N multiples of 8.
//
//   conv   out[m, n] = sum_k A[m, k] W[k, n],  m = (b, ho, wo), n = cout,
//          k = (dy*3 + dx)*Cin + ci (channel fastest: the HWIO kernel
//          reshaped to [9*Cin, Cout]),
//          A[m, k] = q(x[b, ho*s - pad_t + dy, wo*s - pad_l + dx, ci]), 0 outside
//   dense  out[m, n] = sum_k q(x[m, k]) W[k, n]
//   then   y[m, n] = float(acc) * (sx[b] * sw[n]) + bias[n]   (f32)
//
// Two operand modes. int8 x: q is the identity (the reference's
// `_int8_conv` operand). f32 x (quantize on load): q(v) =
// clamp(rint(v / sx[b]), -127, 127) with v / sx the IEEE quotient and rint
// half to even, bit for bit torch.clamp(torch.round(v / sx), -127,
// 127).to(torch.int8) for every finite v (a NaN becomes -127, not torch's
// cast of NaN). It is formed from y = v * rn(1 / sx): y lies within
// 1.5 * 2^-23 |y| of the quotient, so wherever y is farther than 2^-21 |y|
// from every half-integer both round alike; nearer (every tie among them)
// the division decides. sx is one value a row or one for all rows.
//
// Arithmetic. int8 x int8 products summed in int32: exact, in any order
// (|sum| <= 9*Cin*127*127, 2.0e8 at the widest layer; 12288*127*127 = 2.0e8
// at the dense). K is padded with zeros, which adds nothing. The epilogue
// rounds one operation at a time: __int2float_rn, __fmul_rn(sx, sw),
// __fmul_rn, __fadd_rn — no multiply-add is contracted — so the output equals
// ops/int8.py `int8_conv_plain` / `int8_dense_plain` bit for bit.
//
// Paths, chosen by shape in ops/int8.py (`wgmma_tile`, `halo_fits`), each
// counted as the layer's kernel:
//
// The wgmma path (every conv with Cin % 16 == 0 and Cout in {32, 64, 128,
// 256}; the dense with K % 16 == 0 and N one of those or a multiple of 256).
//   - W packed once (ops/int8.py `pack_weight`, at quantize_encoder on the
//     card): [column tiles][K stages][BN][BK] in the K-major core-matrix order
//     the s8 wgmma reads without swizzle (8 rows x 16 bytes of k, the two
//     16-byte halves of a k32 step 128 B apart, 8-row groups 256 B apart), K
//     padded with zeros to whole stages. BK, the stage depth, is the deepest
//     multiple of 32 up to 128 that divides K rounded up to 32: K = 288 takes
//     three stages of 96, not a pad to 384.
//   - One block owns 128 output positions and BN = min(N, 256) columns, so a
//     conv block covers every output channel. Two consumer warpgroups (64
//     positions each) and one producer warp. The producer streams W's stages
//     with TMA bulk copies into a ring of 4 slots in shared memory, each
//     tracked by a `full` mbarrier (expect_tx) and an `empty` one (one arrival
//     a consumer warp). The products are wgmma.mma_async m64nBNk32.s32.s8.s8,
//     both operands from shared memory, two stages' groups in flight: stage
//     s - 1's completion frees its slot. No barrier spans the block inside
//     the K loop.
//   - The A operand, in one of two forms, the halo form wherever a conv's
//     shape takes it:
//       gathered (the dense, and the convs the halo form cannot take): the
//       consumer threads gather and quantize stage s + 1 of
//       the implicit im2col while stage s's products run, into a double
//       buffer of the core-matrix layout — int8 x: one 16-byte load a k16
//       chunk (Cin % 16 == 0 puts a chunk in one tap); f32 x: four threads a
//       chunk, 16 bytes each, so a warp reads 8 rows x 64 contiguous bytes —
//       and meet their warpgroup's other warps at a named barrier. Each input
//       is loaded (and, f32, quantized) once a tap that reads it.
//       halo (convs with Cin a power of two from 32 to 1024, stride 1 with
//       pads of 1 or stride 2): see the halo path below — each input loaded
//       and quantized about once a block, every tap a shifted descriptor.
//     Shared memory, not registers (wgmma's A-from-registers form): a
//     register fragment ties each thread to 4-byte pieces of two rows 8
//     apart — 4-byte int8 loads from scattered rows — and its 16 to 128
//     accumulator registers leave little room to hold a stage's loads.
//   - Epilogue: the accumulators go to shared memory (16-byte chunks XOR
//     swizzled by row) and leave as 16-byte stores, consecutive threads on
//     consecutive bytes of the output rows.
//   - The dense splits K over the blocks (ops/int8.py `dense_splits`: as
//     many splits as fill the card's SMs once, at most one a stage): split z
//     takes stages [z*S/Z, (z+1)*S/Z). Each split writes its int32 partial
//     tile to a workspace the wrapper allocates with torch.empty; the last
//     block of a tile to arrive (a counter per output tile, which that block
//     sets back to 0, so the zeroed counter array the wrapper keeps serves
//     every launch on its stream) adds the partials in split order and applies
//     the epilogue once. One launch.
//
// The first conv (Cin = 1, K = 9, Cout up to 64): too shallow for the tensor
// cores. One output pixel a thread, its nine codes in three words, three
// __dp4a a channel against W's taps packed alike, the epilogue through
// shared memory to 16-byte stores.
//
// The simple path (any other shape): one block of 128 threads owns a
// 64 x BN tile (BN = 32 or 64), four warps of mma.sync.m16n8k32 s8, K in
// steps of 32 gathered straight from device memory (16-byte chunks where
// Cin % 16 == 0, else element by element, f32 quantized as above), W read as
// stored [K, N] and transposed into shared memory; the epilogue goes through
// shared memory to 16-byte stores.
//
// Bound (chip_smoke.py's int8 phase): at B = 1024 every conv of the default
// encoder moves more bytes (x in, f32 out) than its 1.8-58 G int8 operations
// take at the tensor cores' 1979 TOP/s, so bytes bound it in the int8 mode
// and more so in the f32 mode (4 bytes an input); the dense is bound by its
// operations in the int8 mode, by its bytes in the f32 mode.
//
// Measured (an NVIDIA H100 80GB HBM3 at 700 W, B = 1024, the default
// encoder's layers, perf_logs/pr13/phase2.log; PERF.md §6 row 6 has every
// layer): the 8 convs take 2.394 ms with f32 x (bound 0.902) and 1.552 ms
// with int8 x (bound 0.574; PR 10's kernel 3.162), the dense 0.159 / 0.073
// ms (bound 0.0175 / 0.0065; PR 10 0.268). What holds it back, from
// perf_logs/pr13/ablate1.log and fourth.log: at Cout = 32 a wgmma m64n32k32
// takes ~84-112 SM cycles (at 1.755 GHz) where its operations need 16
// (removing the products takes the 96 x 32 conv from 0.42-0.48 to 0.25 ms
// with int8 x), so the narrow layers pay for
// instruction count; and each block's strip or gather, K loop and epilogue
// run one after the other, their latency hidden only by the 1-3 blocks an SM
// holds. The next form: persistent blocks that load the next tile during
// this one (positions as wgmma's N, W as the 64-row operand, measured no
// better at Cout <= 64: perf_logs/pr13/phase3_turned.log).
//
// ptxas (nvcc 12.9, sm_90a; the build log beside the library): the wgmma
// kernels 71 / 96 / 168 registers at BN = 32-64 / 128 / 256, the halo kernels
// 53-64 / 96 / 168; no spills but in the gathered f32 conv kernels (4 bytes
// at BN = 64 and 256, 36 stored / 84 loaded at BN = 128).
//
// A wait on an mbarrier that has not completed after 60 s traps instead of
// hanging the card (csrc/mel_power_ct_split.cu does the same).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const void* x;        // conv: [B, H, W, Cin]; dense: [M, K] — int8 codes, or f32 (the XF32 instantiations)
  const int8_t* w;      // simple path: [K, N] as stored
  const int8_t* wp;     // wgmma path: [n_tiles][n_stages][BN][bk], pack_weight's layout
  const float* sx;      // [B] (sx_stride 1) or one value (sx_stride 0)
  const float* sw;      // [N]
  const float* bias;    // [N]
  float* out;           // [M, N] f32, or null
  int* out_i32;         // [M, N] the raw sums, or null
  int* ws;              // split-K: [splits][M][N] int32 partials
  int* counters;        // split-K: [m_tiles * n_tiles], 0 before and after a launch
  int M, N, K;
  int H, W, Cin, Wo, stride, pad_t, pad_l;
  int rows_per_b;       // Ho * Wo (conv), 1 (dense)
  int sx_stride;
  int bk, n_stages, splits;
  int B;          // images (conv)
};

// ---- quantization and epilogue, shared by both paths ----

// A row's quantization scale and its reciprocal (rounded to nearest).
struct Scale {
  float s, r;
};

__device__ __forceinline__ Scale scale_of(float s) { return Scale{s, __frcp_rn(s)}; }

// rint(v / s) with v / s the IEEE quotient, from y = v * (1/s): y is within
// 1.5 * 2^-23 |y| of that quotient, so where y lies farther than 2^-21 |y|
// from every half-integer both round to the same integer; nearer (ties among
// them), the division decides. |y| >= 129 clamps to +-127 either way.
__device__ __forceinline__ int quant(float v, Scale sc) {
  const float y = __fmul_rn(v, sc.r);
  float k = rintf(y);
  const float a = fabsf(y);
  if (a < 129.f && fabsf(fabsf(y - k) - 0.5f) <= a * 4.76837158203125e-7f) k = rintf(__fdiv_rn(v, sc.s));
  return __float2int_rn(fminf(fmaxf(k, -127.f), 127.f));
}

__device__ __forceinline__ uint32_t quant4(float4 v, Scale s) {
  return (uint32_t)(quant(v.x, s) & 0xff) | ((uint32_t)(quant(v.y, s) & 0xff) << 8) |
         ((uint32_t)(quant(v.z, s) & 0xff) << 16) | ((uint32_t)quant(v.w, s) << 24);
}

__device__ __forceinline__ float dequant(int acc, float sxb, float swn, float bn) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(sxb, swn)), bn);
}

__device__ __forceinline__ float row_scale(const Params& p, int m) {
  return p.sx[(m / p.rows_per_b) * p.sx_stride];
}

// Four outputs of row m at columns n..n+3 (n % 4 == 0, N % 4 == 0): raw sums
// and / or the epilogue, one 16-byte store each.
__device__ __forceinline__ void store4(const Params& p, int m, int n, int4 a, float sxb) {
  const long long o = (long long)m * p.N + n;
  if (p.out_i32) *reinterpret_cast<int4*>(p.out_i32 + o) = a;
  if (p.out)
    *reinterpret_cast<float4*>(p.out + o) =
        make_float4(dequant(a.x, sxb, __ldg(p.sw + n), __ldg(p.bias + n)),
                    dequant(a.y, sxb, __ldg(p.sw + n + 1), __ldg(p.bias + n + 1)),
                    dequant(a.z, sxb, __ldg(p.sw + n + 2), __ldg(p.bias + n + 2)),
                    dequant(a.w, sxb, __ldg(p.sw + n + 3), __ldg(p.bias + n + 3)));
}

// ---- where an A row's k chunks lie ----

// An A row: the offset (elements) of its image (conv) or of the row (dense),
// and the input corner of its 3x3 window; base < 0: no row (past M).
struct Row {
  long long base;
  int h0, w0;
  Scale sx;  // its quantization scale (the f32 mode)
};

template <bool CONV>
__device__ __forceinline__ Row row_at(const Params& p, int m) {
  Row r{-1, 0, 0, Scale{1.f, 1.f}};
  if (m >= p.M) return r;
  const int b = m / p.rows_per_b;
  if (p.sx != nullptr) r.sx = scale_of(p.sx[b * p.sx_stride]);  // the raw int8 mode may pass no scales
  if (CONV) {
    const int rem = m - b * p.rows_per_b;
    const int ho = rem / p.Wo, wo = rem - ho * p.Wo;
    r.base = (long long)b * p.H * p.W * p.Cin;
    r.h0 = ho * p.stride - p.pad_t;
    r.w0 = wo * p.stride - p.pad_l;
  } else {
    r.base = (long long)m * p.K;
  }
  return r;
}

// The thread's next k chunk: conv, its tap (dy*3 + dx) and first channel;
// dense, its first k (in `ci`). Advanced by whole chunks, never by more than
// 2 * Cin, so a conv's channel wraps at most twice.
struct Cursor {
  int tap, ci;
  template <bool CONV>
  __device__ __forceinline__ void advance(int step, int Cin) {
    ci += step;
    if (CONV)
      while (ci >= Cin) {
        ci -= Cin;
        ++tap;
      }
  }
};

template <bool CONV>
__device__ __forceinline__ Cursor cursor_at(const Params& p, int k) {
  if (!CONV) return Cursor{0, k};
  const int tap = k / p.Cin;
  return Cursor{tap, k - tap * p.Cin};
}

// Element offset of the chunk of row r at cursor c, or -1 where it is zero
// (conv padding, K padding, no row). The chunk lies in one tap.
template <bool CONV>
__device__ __forceinline__ long long chunk_off(const Params& p, const Row& r, const Cursor& c) {
  if (r.base < 0) return -1;
  if (!CONV) return c.ci < p.K ? r.base + c.ci : -1;
  if (c.tap >= 9) return -1;
  const int dy = (c.tap * 11) >> 5, dx = c.tap - 3 * dy;  // tap / 3, tap % 3 for tap < 9
  const int h = r.h0 + dy, w = r.w0 + dx;
  if (h < 0 || h >= p.H || w < 0 || w >= p.W) return -1;
  return r.base + ((long long)h * p.W + w) * p.Cin + c.ci;
}

// ---- barriers, copies and products (PTX) ----

__device__ __forceinline__ uint32_t smem_u32(const void* q) { return (uint32_t)__cvta_generic_to_shared(q); }

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

// `bytes` from global memory to `dst`, completing on the barrier `bar` (TMA).
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Named barriers: 1 the 256 consumer threads, 2 + w warpgroup w's 128.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Plain stores to shared memory made visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Operand descriptor: no swizzle, K-major, 8-row x 16-byte core matrices, the
// two halves of a k32 step `lbo` bytes apart (leading byte offset), 8-row
// groups `sbo` apart (stride byte offset): 128 / 256 for the packed W and the
// gathered A; for the halo a channel plane / 128.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo = 128, uint32_t sbo = 256) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// Keep the compiler from moving accesses of the accumulators across a wait.
template <int R>
__device__ __forceinline__ void fence_operand(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x N, s32) = A (64 x 32, s8) * B (32 x N, s8) [+ D if `accumulate`],
// both operands K-major in shared memory. Thread lane 4g + c of warp v of the
// warpgroup holds rows 16v + g (d[4j], d[4j+1]) and 16v + g + 8 (d[4j+2],
// d[4j+3]) at columns 8j + 2c, 8j + 2c + 1.

__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}


template <int BN>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (BN == 32) wgmma_n32(d, da, db, accumulate);
  else if constexpr (BN == 64) wgmma_n64(d, da, db, accumulate);
  else if constexpr (BN == 128) wgmma_n128(d, da, db, accumulate);
  else wgmma_n256(d, da, db, accumulate);
}

// ======================= the wgmma path =======================

constexpr int BM = 128;                  // rows a block: two warpgroups of 64
constexpr int NCONS = 256;               // consumer threads
constexpr int NTHREADS = NCONS + 32;     // and one producer warp
constexpr int STAGES = 4;                // ring slots for W's stages
constexpr int A_STEP = 64 * 32;          // bytes of one warpgroup's k32 step of A

__host__ __device__ constexpr long long wg_main_bytes(int bn, int bk) {
  return (long long)STAGES * bn * bk + 2LL * BM * bk > (long long)BM * bn * 4
             ? (long long)STAGES * bn * bk + 2LL * BM * bk
             : (long long)BM * bn * 4;
}
// The ring, the A double buffer (the epilogue's staging reuses both), then
// 2 * STAGES mbarriers and the split-K flag.
__host__ __device__ constexpr long long wg_smem_bytes(int bn, int bk) {
  return wg_main_bytes(bn, bk) + 16LL * STAGES + 16;
}

// The warpgroup's A rows of the next stage: gathered, quantized (f32 x) and
// written in the core-matrix layout at `a` (this warpgroup's part of a buffer).
template <bool CONV, bool XF32>
struct GatherA {
  Row rows[XF32 ? 2 : 1];
  Cursor cur;
  int t;  // thread in the warpgroup

  __device__ __forceinline__ void init(const Params& p, int m_wg, int t_, int k0) {
    t = t_;
    if (XF32) {
      // four threads a k16 chunk (a 16-byte load of 4 values each), rows q and q + 32
      rows[0] = row_at<CONV>(p, m_wg + (t >> 2));
      rows[1] = row_at<CONV>(p, m_wg + (t >> 2) + 32);
      cur = cursor_at<CONV>(p, k0);
    } else {
      // a thread a k16 chunk: row t % 64, chunks 2i + t / 64
      rows[0] = row_at<CONV>(p, m_wg + (t & 63));
      cur = cursor_at<CONV>(p, k0 + 16 * (t >> 6));
    }
  }

  __device__ __forceinline__ void stage(const Params& p, uint8_t* a, int ks) {
    if (XF32) {
      const float* x = static_cast<const float*>(p.x);
      const int j = t & 3, q = t >> 2;
#pragma unroll 2
      for (int kc = 0; kc < 2 * ks; ++kc) {
        const long long o0 = chunk_off<CONV>(p, rows[0], cur), o1 = chunk_off<CONV>(p, rows[1], cur);
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 v0 = o0 >= 0 ? __ldg(reinterpret_cast<const float4*>(x + o0) + j) : z;
        const float4 v1 = o1 >= 0 ? __ldg(reinterpret_cast<const float4*>(x + o1) + j) : z;
        uint8_t* d = a + (kc >> 1) * A_STEP + (kc & 1) * 128 + 4 * j;
        *reinterpret_cast<uint32_t*>(d + (q >> 3) * 256 + (q & 7) * 16) = quant4(v0, rows[0].sx);
        *reinterpret_cast<uint32_t*>(d + ((q + 32) >> 3) * 256 + (q & 7) * 16) = quant4(v1, rows[1].sx);
        cur.advance<CONV>(16, p.Cin);
      }
    } else {
      const int8_t* x = static_cast<const int8_t*>(p.x);
      const int r = t & 63, h = t >> 6;
#pragma unroll 2
      for (int i = 0; i < ks; ++i) {
        const long long o = chunk_off<CONV>(p, rows[0], cur);
        const int4 v = o >= 0 ? __ldg(reinterpret_cast<const int4*>(x + o)) : make_int4(0, 0, 0, 0);
        *reinterpret_cast<int4*>(a + i * A_STEP + (r >> 3) * 256 + h * 128 + (r & 7) * 16) = v;
        cur.advance<CONV>(32, p.Cin);
      }
    }
  }
};

template <bool CONV, bool XF32, int BN>
__global__ void __launch_bounds__(NTHREADS, BN <= 64 ? 3 : (BN == 128 ? 2 : 1))
int8_wgmma_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int bk = p.bk, ks = bk / 32;
  uint8_t* ring = smem;                       // STAGES x [BN][bk]
  uint8_t* abuf = ring + STAGES * BN * bk;    // 2 x [BM][bk]: warpgroup w's rows at + w * 64 * bk
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + wg_main_bytes(BN, bk));
  int* last_flag = reinterpret_cast<int*>(bars + 2 * STAGES);
  const uint32_t full0 = smem_u32(bars);      // full[s] = full0 + 8 s, empty[s] = full0 + 8 (STAGES + s)

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int z = blockIdx.z;
  const int s_begin = (int)((long long)z * p.n_stages / p.splits);
  const int n_steps = (int)((long long)(z + 1) * p.n_stages / p.splits) - s_begin;
  const int stage_bytes = BN * bk;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                         // the producer's expect_tx
      mbar_init(full0 + 8 * (STAGES + s), NCONS / 32);     // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCONS / 32) {
    // the producer: lane 0 streams this tile's W stages into the ring
    if (lane == 0) {
      const int8_t* src = p.wp + ((long long)blockIdx.y * p.n_stages + s_begin) * stage_bytes;
      int slot = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_steps; ++i) {
        mbar_wait(full0 + 8 * (STAGES + slot), phase ^ 1);
        mbar_expect_tx(full0 + 8 * slot, stage_bytes);
        bulk_copy(smem_u32(ring + slot * stage_bytes), src + (long long)i * stage_bytes, stage_bytes,
                  full0 + 8 * slot);
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows m0 + 64 wg .. + 63
  const int wg = warp >> 2, t = tid & 127;
  uint8_t* a_wg = abuf + wg * 64 * bk;
  GatherA<CONV, XF32> ga;
  ga.init(p, m0 + 64 * wg, t, s_begin * bk);
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  ga.stage(p, a_wg, ks);
  fence_async_smem();
  bar_sync(2 + wg, 128);
  // two stages' products in flight: stage i is issued, then stage i - 1's
  // completion frees its W slot and its A buffer, which stage i + 1 is
  // gathered into while stage i runs
  int slot = 0, prev = 0;
  uint32_t phase = 0;
#pragma unroll 1
  for (int i = 0; i < n_steps; ++i) {
    mbar_wait(full0 + 8 * slot, phase);
    const uint32_t a_addr = smem_u32(a_wg + (i & 1) * BM * bk), w_addr = smem_u32(ring + slot * stage_bytes);
    fence_operand(acc);
    wgmma_fence();
#pragma unroll 1
    for (int j = 0; j < ks; ++j) wgmma<BN>(acc, desc(a_addr + j * A_STEP), desc(w_addr + j * BN * 32), i | j);
    wgmma_commit();
    if (i > 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(full0 + 8 * (STAGES + prev));
    }
    prev = slot;
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1;
    }
    if (i + 1 < n_steps) {
      ga.stage(p, a_wg + ((i + 1) & 1) * BM * bk, ks);  // under stage i's products
      fence_async_smem();
      bar_sync(2 + wg, 128);
    }
  }
  wgmma_wait<0>();
  fence_operand(acc);
  if (lane == 0) mbar_arrive(full0 + 8 * (STAGES + prev));

  // epilogue: both warpgroups are done with the ring and A before either
  // overwrites them with its accumulators ([64][BN] int32, 16-byte chunks
  // XOR swizzled by row: chunk q of row r at q ^ (r & 7))
  bar_sync(1, NCONS);
  int* stg = reinterpret_cast<int*>(smem) + wg * 64 * BN;
  {
    const int v = warp & 3, g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * v + g + 8 * h, q = 2 * j + (c >> 1);
        *reinterpret_cast<int2*>(stg + r * BN + ((q ^ (r & 7)) << 2) + 2 * (c & 1)) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }
  bar_sync(2 + wg, 128);
  constexpr int QN = BN / 4;  // 16-byte chunks a row
  const int n0 = blockIdx.y * BN;
  if (p.splits == 1) {
#pragma unroll 4
    for (int id = t; id < 64 * QN; id += 128) {
      const int r = id / QN, q = id - r * QN, m = m0 + 64 * wg + r;
      if (m >= p.M) break;  // rows run in order: the rest are past M too
      const int4 a = *reinterpret_cast<const int4*>(stg + r * BN + ((q ^ (r & 7)) << 2));
      store4(p, m, n0 + 4 * q, a, p.out ? row_scale(p, m) : 0.f);
    }
    return;
  }
  // split-K: this split's partial tile, then the last block of the tile adds them
  int* part = p.ws + (long long)z * p.M * p.N;
  for (int id = t; id < 64 * QN; id += 128) {
    const int r = id / QN, q = id - r * QN, m = m0 + 64 * wg + r;
    if (m >= p.M) break;
    *reinterpret_cast<int4*>(part + (long long)m * p.N + n0 + 4 * q) =
        *reinterpret_cast<const int4*>(stg + r * BN + ((q ^ (r & 7)) << 2));
  }
  __threadfence();
  bar_sync(1, NCONS);
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) *last_flag = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  bar_sync(1, NCONS);
  if (!*last_flag) return;
  __threadfence();
  for (int id = tid; id < BM * QN; id += NCONS) {
    const int r = id / QN, q = id - r * QN, m = m0 + r;
    if (m >= p.M) break;
    const long long o = (long long)m * p.N + n0 + 4 * q;
    int4 s = make_int4(0, 0, 0, 0);
    for (int zz = 0; zz < p.splits; ++zz) {
      const int4 v = __ldcg(reinterpret_cast<const int4*>(p.ws + (long long)zz * p.M * p.N + o));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    store4(p, m, n0 + 4 * q, s, p.out ? row_scale(p, m) : 0.f);
  }
  if (tid == 0) p.counters[tile] = 0;  // ready for the next launch on this stream
}

// ======================= the halo path (stride 1 and 2) =======================
//
// A 3x3 conv computed over a grid of positions per image in which every tap
// is a constant shift. Stride 1 (pads 1): the zero-padded input's grid,
// (H + 2) x (W + 2); position o = (b, i, j) reads padded pixel o + dy (W + 2)
// + dx at tap (dy, dx). Stride 2: four phase planes of the padded input,
// plane (a, c) holding padded pixels (2i + a, 2j + c) on a (Ho + 1) x
// (Wo + 1) grid; tap (dy, dx) reads plane (dy % 2, dx % 2) at o + (dy / 2)
// (Wo + 1) + dx / 2. So the operand rows of every tap are one window of a
// strip of grid rows, shifted: a block loads its 128 positions' rows and the
// largest shift more of each plane once — quantized once, not once a tap —
// into shared memory as channel planes ([plane][Cin / 16][rows][16 bytes]),
// and each k32 step's operand is a descriptor into that strip (8-row groups
// 128 B apart, the two 16-channel halves a channel plane apart). Positions
// past the output (i >= Ho, j >= Wo) are computed and dropped. Needs Cin a
// power of two from 32 to 1024 (a k32 step in one tap; a row's loads
// dividing the threads).
//
// Positions are wgmma's M: a warpgroup takes 64 positions x Cout
// (m64nCoutk32), a block 128. (A block turned the other way — W as the
// 64-row operand, 128 positions a warpgroup as N — measured slower at Cout =
// 32 with f32 x and within 0.06 ms elsewhere: perf_logs/pr13/phase3_turned.log.)

__host__ __device__ constexpr int halo_planes(int stride) { return stride == 1 ? 1 : 4; }
// rows of each plane's strip, and the stride (in rows, 16 B each) between
// its channel planes: a multiple of 8 plus one, so that a warp's 4-byte
// stores to 8 channel planes fall on 8 bank groups
__host__ __device__ constexpr int halo_strip(int stride, int gw) { return BM + (stride == 1 ? 2 * gw + 2 : gw + 1); }
__host__ __device__ constexpr int halo_rows(int stride, int gw) { return (halo_strip(stride, gw) + 7) / 8 * 8 + 1; }

__host__ __device__ constexpr long long halo_main_bytes(int bn, int bk, int cin, int planes, int hr) {
  return (long long)STAGES * bn * bk + (long long)planes * cin * hr > (long long)BM * bn * 4
             ? (long long)STAGES * bn * bk + (long long)planes * cin * hr
             : (long long)BM * bn * 4;
}
// The ring and the strips (the epilogue's staging reuses both), the
// mbarriers, each position's output row and scale, each strip row's source
// offset and scale.
__host__ __device__ constexpr long long halo_smem_bytes(int bn, int bk, int cin, int stride, int gw) {
  return halo_main_bytes(bn, bk, cin, halo_planes(stride), halo_rows(stride, gw)) + 16LL * STAGES + 8LL * BM +
         12LL * halo_planes(stride) * halo_strip(stride, gw);
}

template <bool XF32, int BN>
__global__ void __launch_bounds__(NTHREADS, BN <= 64 ? 3 : (BN == 128 ? 2 : 1))
int8_halo_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int st = p.stride, planes = halo_planes(st), cin = p.Cin;
  const int ho_n = p.rows_per_b / p.Wo;
  const int gw = st == 1 ? p.W + 2 : p.Wo + 1, gh = st == 1 ? p.H + 2 : ho_n + 1, img = gh * gw;
  const int strip = halo_strip(st, gw), hr = halo_rows(st, gw);
  const int bk = p.bk, ks = bk / 32;
  const int stage_bytes = BN * bk;
  uint8_t* ring = smem;                           // STAGES x [BN][bk]
  uint8_t* halo = ring + STAGES * stage_bytes;    // [planes][cin / 16][hr][16]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + halo_main_bytes(BN, bk, cin, planes, hr));
  int* m_row = reinterpret_cast<int*>(bars + 2 * STAGES);  // [BM] output row of each position, or -1
  float* sx_row = reinterpret_cast<float*>(m_row + BM);    // [BM] its scale
  int* src_row = reinterpret_cast<int*>(sx_row + BM);      // [planes * strip] source pixel offset, or -1
  Scale* sc_row = reinterpret_cast<Scale*>(src_row + planes * strip);  // [planes * strip] its scale
  const uint32_t full0 = smem_u32(bars);

  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int n_pos = p.B * img;
  const int o0 = blockIdx.x * BM;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(full0 + 8 * (STAGES + s), NCONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCONS / 32) {
    if (lane == 0) {
      int slot = 0;
      uint32_t phase = 0;
      for (int i = 0; i < p.n_stages; ++i) {
        mbar_wait(full0 + 8 * (STAGES + slot), phase ^ 1);
        mbar_expect_tx(full0 + 8 * slot, stage_bytes);
        bulk_copy(smem_u32(ring + slot * stage_bytes), p.wp + (long long)i * stage_bytes, stage_bytes,
                  full0 + 8 * slot);
        if (++slot == STAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // where each strip row comes from, and each position goes
  for (int e = tid; e < planes * strip; e += NCONS) {
    const int pl = e / strip, r = e - pl * strip, o = o0 + r;
    const int b = o / img, q = o - b * img, i = q / gw, j = q - i * gw;
    const int h = st * i + (pl >> 1) - p.pad_t, w = st * j + (pl & 1) - p.pad_l;
    const bool in = o < n_pos && h >= 0 && h < p.H && w >= 0 && w < p.W;
    src_row[e] = in ? ((b * p.H + h) * p.W + w) * cin : -1;
    if (XF32 && in) sc_row[e] = scale_of(p.sx[b * p.sx_stride]);
  }
  for (int r = tid; r < BM; r += NCONS) {
    const int o = o0 + r, b = o / img, q = o - b * img, i = q / gw, j = q - i * gw;
    const bool real = o < n_pos && i < ho_n && j < p.Wo;
    m_row[r] = real ? (b * ho_n + i) * p.Wo + j : -1;
    sx_row[r] = real && p.out ? p.sx[b * p.sx_stride] : 0.f;
  }
  bar_sync(1, NCONS);

  // the strips, quantized once, while the first W stages land: a thread
  // loads one column of PER channels of every (NCONS / lpr)-th row, four
  // rows' loads in flight before their stores
  {
    constexpr int PER = XF32 ? 4 : 16;      // channels a load
    const int lpr = cin / PER;              // loads a row (divides NCONS)
    const int f = tid & (lpr - 1), step = NCONS / lpr, n_rows = planes * strip;
    uint8_t* dst = halo + (XF32 ? (f >> 2) * hr * 16 + (f & 3) * 4 : f * hr * 16);
#pragma unroll 1
    for (int e0 = tid / lpr; e0 < n_rows; e0 += 4 * step) {
      if (XF32) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * step, so = e < n_rows ? src_row[e] : -1;
          v[u] = so >= 0 ? __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p.x) + so) + f)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * step;
          if (e >= n_rows) break;
          const int pl = e / strip, r = e - pl * strip;
          *reinterpret_cast<uint32_t*>(dst + (pl * (cin / 16) * hr + r) * 16) =
              src_row[e] >= 0 ? quant4(v[u], sc_row[e]) : 0u;
        }
      } else {
        int4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * step, so = e < n_rows ? src_row[e] : -1;
          v[u] = so >= 0 ? __ldg(reinterpret_cast<const int4*>(static_cast<const int8_t*>(p.x) + so) + f)
                         : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * step;
          if (e >= n_rows) break;
          const int pl = e / strip, r = e - pl * strip;
          *reinterpret_cast<int4*>(dst + (pl * (cin / 16) * hr + r) * 16) = v[u];
        }
      }
    }
  }
  fence_async_smem();
  bar_sync(1, NCONS);

  const int wg = warp >> 2, t = tid & 127;
  const uint32_t pos_wg = smem_u32(halo) + 64 * wg * 16;  // this warpgroup's first position in the strips
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  // two stages' products in flight: stage i - 1's completion frees its slot
  int slot = 0, prev = 0;
  uint32_t phase = 0;
#pragma unroll 1
  for (int i = 0; i < p.n_stages; ++i) {
    mbar_wait(full0 + 8 * slot, phase);
    const uint32_t w_addr = smem_u32(ring + slot * stage_bytes);
    fence_operand(acc);
    wgmma_fence();
#pragma unroll 1
    for (int j = 0; j < ks; ++j) {
      const int k = (i * ks + j) * 32;
      if (k >= p.K) break;  // K padding: W's zeros
      const int tap = k / cin, c = (k - tap * cin) >> 4;
      const int dy = (tap * 11) >> 5, dx = tap - 3 * dy;
      const int pl = st == 1 ? 0 : (dy & 1) * 2 + (dx & 1);
      const int shift = st == 1 ? dy * gw + dx : (dy >> 1) * gw + (dx >> 1);
      const uint32_t a = pos_wg + ((pl * (cin / 16) + c) * hr + shift) * 16;
      wgmma<BN>(acc, desc(a, hr * 16, 128), desc(w_addr + j * BN * 32), i | j);
    }
    wgmma_commit();
    if (i > 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(full0 + 8 * (STAGES + prev));
    }
    prev = slot;
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_operand(acc);
  if (lane == 0) mbar_arrive(full0 + 8 * (STAGES + prev));

  bar_sync(1, NCONS);  // both warpgroups are done with the ring and the strips
  int* stg = reinterpret_cast<int*>(smem) + wg * 64 * BN;
  {
    const int v = warp & 3, g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * v + g + 8 * h, q = 2 * j + (c >> 1);
        *reinterpret_cast<int2*>(stg + r * BN + ((q ^ (r & 7)) << 2) + 2 * (c & 1)) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }
  bar_sync(2 + wg, 128);
  constexpr int QN = BN / 4;
#pragma unroll 4
  for (int id = t; id < 64 * QN; id += 128) {
    const int r = id / QN, q = id - r * QN, m = m_row[64 * wg + r];
    if (m < 0) continue;
    const int4 a = *reinterpret_cast<const int4*>(stg + r * BN + ((q ^ (r & 7)) << 2));
    store4(p, m, 4 * q, a, sx_row[64 * wg + r]);
  }
}

// ======================= the simple path =======================

constexpr int SBM = 64;       // output rows a block
constexpr int SBK = 32;       // k a step (one m16n8k32)
constexpr int STHREADS = 128; // four warps, 2 x 2
constexpr int LDS = 48;       // bytes between shared rows (32 used)

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One code of the A operand (conv: the implicit im2col; dense: x itself).
template <bool CONV, bool XF32>
__device__ __forceinline__ int8_t a_elem(const Params& p, const Row& r, int k) {
  if (r.base < 0 || k >= p.K) return 0;
  long long o;
  if (CONV) {
    const int tap = k / p.Cin, ci = k - tap * p.Cin;
    const int dy = tap / 3, dx = tap - dy * 3;
    const int h = r.h0 + dy, w = r.w0 + dx;
    if (h < 0 || h >= p.H || w < 0 || w >= p.W) return 0;
    o = r.base + ((long long)h * p.W + w) * p.Cin + ci;
  } else {
    o = r.base + k;
  }
  if (XF32) return (int8_t)quant(__ldg(static_cast<const float*>(p.x) + o), r.sx);
  return __ldg(static_cast<const int8_t*>(p.x) + o);
}

template <bool CONV, bool XF32, bool VEC_A, bool VEC_B, int BN>
__global__ void __launch_bounds__(STHREADS) int8_mma_kernel(const Params p) {
  constexpr int WN = BN / 2;   // columns a warp
  constexpr int NI = WN / 8;   // n8 tiles a warp
  constexpr int B_CHUNKS = SBK * BN / 16;  // 16-byte chunks of the W tile
  constexpr int CS = BN + 4;   // ints between rows of the epilogue's staging
  __shared__ __align__(16) int8_t As[SBM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  __shared__ __align__(16) int Cs[SBM * CS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.x * SBM;
  const int n0 = blockIdx.y * BN;

  // this thread's A row and half step
  const int ar = tid >> 1, ac = (tid & 1) * 16;
  const Row row = row_at<CONV>(p, m0 + ar);
  // this thread's W row and 16 columns
  const int bk = tid / (BN / 16), bc = (tid % (BN / 16)) * 16;

  int acc[2][NI][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * WN;
  const int k_pad = (p.K + SBK - 1) / SBK * SBK;
  for (int k0 = 0; k0 < k_pad; k0 += SBK) {
    // A tile: 64 rows x 32 k
    {
      const int k = k0 + ac;
      int4 v = make_int4(0, 0, 0, 0);
      if (VEC_A) {
        const long long o = chunk_off<CONV>(p, row, cursor_at<CONV>(p, k));
        if (o >= 0) {
          if (XF32) {
            const float4* xf = reinterpret_cast<const float4*>(static_cast<const float*>(p.x) + o);
            v = make_int4((int)quant4(__ldg(xf), row.sx), (int)quant4(__ldg(xf + 1), row.sx),
                          (int)quant4(__ldg(xf + 2), row.sx), (int)quant4(__ldg(xf + 3), row.sx));
          } else {
            v = __ldg(reinterpret_cast<const int4*>(static_cast<const int8_t*>(p.x) + o));
          }
        }
      } else {
        int8_t* vb = reinterpret_cast<int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < 16; ++j) vb[j] = a_elem<CONV, XF32>(p, row, k + j);
      }
      *reinterpret_cast<int4*>(As + ar * LDS + ac) = v;
    }
    // W tile: 32 k x BN n, stored transposed as [n][k]
    if (tid < B_CHUNKS) {
      const int k = k0 + bk, n = n0 + bc;
      int4 v = make_int4(0, 0, 0, 0);
      int8_t* vb = reinterpret_cast<int8_t*>(&v);
      if (k < p.K) {
        const int8_t* src = p.w + (long long)k * p.N + n;
        if (VEC_B) {
          if (n < p.N) v = *reinterpret_cast<const int4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) vb[j] = (n + j < p.N) ? src[j] : (int8_t)0;
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) Bs[(bc + j) * LDS + bk] = vb[j];
    }
    __syncthreads();

    int a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* r0 = As + (wm + i * 16 + g) * LDS + t4 * 4;
      const int8_t* r1 = r0 + 8 * LDS;
      a[i][0] = *reinterpret_cast<const int*>(r0);
      a[i][1] = *reinterpret_cast<const int*>(r1);
      a[i][2] = *reinterpret_cast<const int*>(r0 + 16);
      a[i][3] = *reinterpret_cast<const int*>(r1 + 16);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int8_t* c = Bs + (wn + j * 8 + g) * LDS + t4 * 4;
      const int b0 = *reinterpret_cast<const int*>(c);
      const int b1 = *reinterpret_cast<const int*>(c + 16);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b0, b1);
    }
    __syncthreads();
  }

  // epilogue: the tile through shared memory, then 16-byte stores (4 columns)
  // where N % 4 == 0, else one column at a time
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < NI; ++j)
        *reinterpret_cast<int2*>(Cs + (wm + i * 16 + g + half * 8) * CS + wn + j * 8 + t4 * 2) =
            make_int2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
  __syncthreads();
  for (int id = tid; id < SBM * (BN / 4); id += STHREADS) {
    const int r = id / (BN / 4), q = id - r * (BN / 4), m = m0 + r, n = n0 + 4 * q;
    if (m >= p.M) break;
    if (n >= p.N) continue;
    const int4 a = *reinterpret_cast<const int4*>(Cs + r * CS + 4 * q);
    const float sxb = p.out ? row_scale(p, m) : 0.f;
    if (p.N % 4 == 0) {
      store4(p, m, n, a, sxb);
    } else {
      const int av[4] = {a.x, a.y, a.z, a.w};
      for (int e = 0; e < 4 && n + e < p.N; ++e) {
        const long long o = (long long)m * p.N + n + e;
        if (p.out_i32) p.out_i32[o] = av[e];
        if (p.out) p.out[o] = dequant(av[e], sxb, p.sw[n + e], p.bias[n + e]);
      }
    }
  }
}

// ======================= the first conv (Cin = 1) =======================
//
// K = 9: too shallow for the tensor cores to pay. One output pixel a thread:
// its nine codes packed four to a 32-bit word (the ninth with three zeros),
// three __dp4a a channel against W's taps packed alike in shared memory,
// then the epilogue through shared memory to 16-byte stores.

constexpr int C1_ROWS = 128;  // output pixels a block, one a thread

template <bool XF32, int NC>
__global__ void __launch_bounds__(C1_ROWS) int8_conv1_kernel(const Params p) {
  constexpr int CS = NC + 4;  // ints between the staging's rows (16-byte stores a quarter-warp on 8 bank groups)
  __shared__ int wsm[3][NC];
  __shared__ __align__(16) int stg[C1_ROWS * CS];
  __shared__ float sxs[C1_ROWS];
  const int tid = threadIdx.x, m0 = blockIdx.x * C1_ROWS;
  for (int i = tid; i < 3 * NC; i += C1_ROWS) {
    const int j = i / NC, n = i - j * NC;
    uint32_t v = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * j + e < 9) v |= (uint32_t)(uint8_t)p.w[(4 * j + e) * NC + n] << (8 * e);
    wsm[j][n] = (int)v;
  }
  const Row r = row_at<true>(p, m0 + tid);
  int c[3] = {0, 0, 0};
  if (r.base >= 0) {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int h = r.h0 + t / 3, w = r.w0 + t % 3;
      int q = 0;
      if (h >= 0 && h < p.H && w >= 0 && w < p.W) {
        const long long o = r.base + (long long)h * p.W + w;
        q = XF32 ? quant(__ldg(static_cast<const float*>(p.x) + o), r.sx)
                 : (int)__ldg(static_cast<const int8_t*>(p.x) + o);
      }
      c[t >> 2] |= (int)((uint32_t)(q & 0xff) << (8 * (t & 3)));
    }
  }
  sxs[tid] = r.base >= 0 && p.out ? r.sx.s : 0.f;
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NC; n += 4) {
    int4 a;
    a.x = __dp4a(c[2], wsm[2][n], __dp4a(c[1], wsm[1][n], __dp4a(c[0], wsm[0][n], 0)));
    a.y = __dp4a(c[2], wsm[2][n + 1], __dp4a(c[1], wsm[1][n + 1], __dp4a(c[0], wsm[0][n + 1], 0)));
    a.z = __dp4a(c[2], wsm[2][n + 2], __dp4a(c[1], wsm[1][n + 2], __dp4a(c[0], wsm[0][n + 2], 0)));
    a.w = __dp4a(c[2], wsm[2][n + 3], __dp4a(c[1], wsm[1][n + 3], __dp4a(c[0], wsm[0][n + 3], 0)));
    *reinterpret_cast<int4*>(stg + tid * CS + n) = a;
  }
  __syncthreads();
  constexpr int QN = NC / 4;
#pragma unroll 4
  for (int id = tid; id < C1_ROWS * QN; id += C1_ROWS) {
    const int rr = id / QN, q = id - rr * QN, m = m0 + rr;
    if (m >= p.M) break;
    store4(p, m, 4 * q, *reinterpret_cast<const int4*>(stg + rr * CS + 4 * q), sxs[rr]);
  }
}

template <bool XF32>
cudaError_t launch_conv1(const Params& p, cudaStream_t st) {
  const unsigned grid = (unsigned)((p.M + C1_ROWS - 1) / C1_ROWS);
  switch (p.N) {
    case 4: int8_conv1_kernel<XF32, 4><<<grid, C1_ROWS, 0, st>>>(p); break;
    case 8: int8_conv1_kernel<XF32, 8><<<grid, C1_ROWS, 0, st>>>(p); break;
    case 16: int8_conv1_kernel<XF32, 16><<<grid, C1_ROWS, 0, st>>>(p); break;
    case 32: int8_conv1_kernel<XF32, 32><<<grid, C1_ROWS, 0, st>>>(p); break;
    default: int8_conv1_kernel<XF32, 64><<<grid, C1_ROWS, 0, st>>>(p); break;
  }
  return cudaGetLastError();
}

// ======================= launches =======================

template <bool CONV, bool XF32, bool VEC_A, bool VEC_B>
cudaError_t launch_simple(const Params& p, cudaStream_t st) {
  const unsigned mt = (unsigned)((p.M + SBM - 1) / SBM);
  if (p.N <= 32) {
    int8_mma_kernel<CONV, XF32, VEC_A, VEC_B, 32><<<dim3(mt, (p.N + 31) / 32), STHREADS, 0, st>>>(p);
  } else {
    int8_mma_kernel<CONV, XF32, VEC_A, VEC_B, 64><<<dim3(mt, (p.N + 63) / 64), STHREADS, 0, st>>>(p);
  }
  return cudaGetLastError();
}

template <bool CONV, bool XF32>
cudaError_t dispatch_simple(const Params& p, bool vec_a, cudaStream_t st) {
  const bool vec_b = p.N % 16 == 0;
  if (vec_a) return vec_b ? launch_simple<CONV, XF32, true, true>(p, st) : launch_simple<CONV, XF32, true, false>(p, st);
  return vec_b ? launch_simple<CONV, XF32, false, true>(p, st) : launch_simple<CONV, XF32, false, false>(p, st);
}

template <bool CONV, bool XF32, int BN>
cudaError_t launch_wgmma_bn(const Params& p, int n_tiles, cudaStream_t st) {
  const long long smem = wg_smem_bytes(BN, p.bk);
  auto kernel = int8_wgmma_kernel<CONV, XF32, BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.M + BM - 1) / BM), (unsigned)n_tiles, (unsigned)p.splits);
  kernel<<<grid, NTHREADS, (size_t)smem, st>>>(p);
  return cudaGetLastError();
}

template <bool XF32, int BN>
cudaError_t launch_halo_bn(const Params& p, cudaStream_t st) {
  const int gw = p.stride == 1 ? p.W + 2 : p.Wo + 1, gh = p.stride == 1 ? p.H + 2 : p.rows_per_b / p.Wo + 1;
  const long long smem = halo_smem_bytes(BN, p.bk, p.Cin, p.stride, gw);
  auto kernel = int8_halo_kernel<XF32, BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(((long long)p.B * gh * gw + BM - 1) / BM), NTHREADS, (size_t)smem, st>>>(p);
  return cudaGetLastError();
}

template <bool XF32>
cudaError_t launch_halo(const Params& p, cudaStream_t st) {
  switch (p.N) {
    case 32: return launch_halo_bn<XF32, 32>(p, st);
    case 64: return launch_halo_bn<XF32, 64>(p, st);
    case 128: return launch_halo_bn<XF32, 128>(p, st);
    default: return launch_halo_bn<XF32, 256>(p, st);
  }
}

template <bool CONV, bool XF32>
cudaError_t launch_wgmma(const Params& p, int bn, cudaStream_t st) {
  const int n_tiles = p.N / bn;
  switch (bn) {
    case 32: return launch_wgmma_bn<CONV, XF32, 32>(p, n_tiles, st);
    case 64: return launch_wgmma_bn<CONV, XF32, 64>(p, n_tiles, st);
    case 128: return launch_wgmma_bn<CONV, XF32, 128>(p, n_tiles, st);
    default: return launch_wgmma_bn<CONV, XF32, 256>(p, n_tiles, st);
  }
}

// The wgmma path's geometry: BN in {32, 64, 128, 256} dividing N (one column
// tile unless N is a multiple of 256), bk a multiple of 32 up to 128, the
// stages covering K, shared memory within the card's 227 KB.
bool wgmma_ok(int N, int K, int bn, int bk, int n_stages) {
  return (bn == 32 || bn == 64 || bn == 128 || bn == 256) && N % bn == 0 && (N == bn || bn == 256) &&
         bk >= 32 && bk <= 128 && bk % 32 == 0 && n_stages >= 1 && (long long)n_stages * bk >= K &&
         (long long)(n_stages - 1) * bk < K && wg_smem_bytes(bn, bk) <= 232448;
}

}  // namespace

extern "C" {

// 3x3 conv over NHWC x [B, H, W, Cin] (int8 codes, or f32 with x_f32 = 1:
// quantized on load by sx), output [B, Ho, Wo, Cout] (f32 `out` and / or
// int32 `out_i32`; either may be null). `wp` (pack_weight's [1][n_stages][Cout]
// [bk]) takes the wgmma path — with `halo`, its halo form (Cin a power of two
// from 32 to 1024; stride 1 with pads of 1, or stride 2); null takes the
// simple path with `w` (HWIO as [9 * Cin, Cout]). Returns the cudaError_t of
// the launch (0 = success).
int int8_conv_launch(const void* x, int x_f32, const void* w, const void* wp, int bk, int n_stages, int halo,
                     const float* sx, int sx_stride, const float* sw, const float* bias, float* out, int* out_i32,
                     int B, int H, int W, int Cin, int Cout, int Ho, int Wo, int stride, int pad_t, int pad_l,
                     void* stream) {
  const long long M = (long long)B * Ho * Wo;
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || Ho < 1 || Wo < 1 || stride < 1 ||
      (out == nullptr && out_i32 == nullptr) || (out != nullptr && (sw == nullptr || bias == nullptr)) ||
      ((out != nullptr || x_f32) && sx == nullptr) || M + BM >= (1LL << 31) || (long long)B * H * W * Cin >= (1LL << 40) || (Cout + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x; p.w = static_cast<const int8_t*>(w); p.wp = static_cast<const int8_t*>(wp);
  p.sx = sx; p.sx_stride = sx_stride; p.sw = sw; p.bias = bias; p.out = out; p.out_i32 = out_i32;
  p.M = (int)M; p.N = Cout; p.K = 9 * Cin;
  p.H = H; p.W = W; p.Cin = Cin; p.Wo = Wo; p.stride = stride; p.pad_t = pad_t; p.pad_l = pad_l;
  p.rows_per_b = Ho * Wo;
  p.splits = 1;
  p.B = B;
  const cudaStream_t st = (cudaStream_t)stream;
  if (wp != nullptr) {
    if (Cin % 16 != 0 || !wgmma_ok(Cout, p.K, Cout, bk, n_stages)) return (int)cudaErrorInvalidValue;
    p.bk = bk; p.n_stages = n_stages;
    if (halo) {
      const int gw = stride == 1 ? W + 2 : Wo + 1, gh = stride == 1 ? H + 2 : Ho + 1;
      const bool pow2 = Cin >= 32 && Cin <= 1024 && (Cin & (Cin - 1)) == 0;
      if (!pow2 || stride > 2 || (stride == 1 && (pad_t != 1 || pad_l != 1 || Ho != H || Wo != W)) ||
          (long long)B * gh * gw >= (1LL << 31) - BM || (long long)B * H * W * Cin >= (1LL << 31) ||
          halo_smem_bytes(Cout, bk, Cin, stride, gw) > 232448)
        return (int)cudaErrorInvalidValue;
      return (int)(x_f32 ? launch_halo<true>(p, st) : launch_halo<false>(p, st));
    }
    return (int)(x_f32 ? launch_wgmma<true, true>(p, Cout, st) : launch_wgmma<true, false>(p, Cout, st));
  }
  if (w == nullptr) return (int)cudaErrorInvalidValue;
  if (Cin == 1 && (Cout == 4 || Cout == 8 || Cout == 16 || Cout == 32 || Cout == 64))
    return (int)(x_f32 ? launch_conv1<true>(p, st) : launch_conv1<false>(p, st));
  return (int)(x_f32 ? dispatch_simple<true, true>(p, Cin % 16 == 0, st)
                     : dispatch_simple<true, false>(p, Cin % 16 == 0, st));
}

// dense: x [M, K] (int8 codes, or f32 with x_f32 = 1) times W [K, N], output
// [M, N]. `wp` (pack_weight's [N / bn][n_stages][bn][bk]) takes the wgmma
// path, split over `splits` blocks along K: `ws` holds splits * M * N int32
// partials and `counters` (m_tiles * N / bn ints, zero) the tiles' arrivals
// (both unused at splits = 1). Null `wp`: the simple path with `w`.
int int8_dense_launch(const void* x, int x_f32, const void* w, const void* wp, int bk, int n_stages, int bn,
                      int splits, int* ws, int* counters, const float* sx, int sx_stride, const float* sw,
                      const float* bias, float* out, int* out_i32, int M, int K, int N, void* stream) {
  if (M < 1 || K < 1 || N < 1 || (out == nullptr && out_i32 == nullptr) ||
      (out != nullptr && (sw == nullptr || bias == nullptr)) || ((out != nullptr || x_f32) && sx == nullptr) ||
      M >= (1 << 30) ||
      (N + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x; p.w = static_cast<const int8_t*>(w); p.wp = static_cast<const int8_t*>(wp);
  p.sx = sx; p.sx_stride = sx_stride; p.sw = sw; p.bias = bias; p.out = out; p.out_i32 = out_i32;
  p.M = M; p.N = N; p.K = K; p.rows_per_b = 1;
  p.splits = 1;
  const cudaStream_t st = (cudaStream_t)stream;
  if (wp != nullptr) {
    if (K % 16 != 0 || !wgmma_ok(N, K, bn, bk, n_stages) || splits < 1 || splits > n_stages || splits > 65535 ||
        (splits > 1 && (ws == nullptr || counters == nullptr)))
      return (int)cudaErrorInvalidValue;
    p.bk = bk; p.n_stages = n_stages; p.splits = splits; p.ws = ws; p.counters = counters;
    return (int)(x_f32 ? launch_wgmma<false, true>(p, bn, st) : launch_wgmma<false, false>(p, bn, st));
  }
  if (w == nullptr) return (int)cudaErrorInvalidValue;
  return (int)(x_f32 ? dispatch_simple<false, true>(p, K % 16 == 0, st)
                     : dispatch_simple<false, false>(p, K % 16 == 0, st));
}

}  // extern "C"
