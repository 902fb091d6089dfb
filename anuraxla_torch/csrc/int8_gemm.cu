// Int8 contractions of the quantized serving encoder on Hopper's integer
// tensor cores: an implicit-GEMM 3x3 conv over NHWC int8 input and an int8
// dense layer, each with int32 sums and a float epilogue.
//
// Replaces the int8 contractions of anuraxla/models/quant.py, which are not
// Pallas kernels: `_int8_conv` (:204, lax.conv_general_dilated on int8
// operands, preferred_element_type=int32) and `_int8_dot` (:198,
// lax.dot_general likewise), each followed by the dequantization at :245 /
// :257, y * (sx * sw) + bias. PyTorch has no int8 convolution on CUDA, and
// its int8 matrix product (torch._int_mm) takes only more than 16 rows and K,
// N multiples of 8, which the first conv (K = 9) and a batch of one miss.
//
//   conv   out[m, n] = sum_k A[m, k] W[k, n],  m = (b, ho, wo), n = cout,
//          k = (dy*3 + dx)*Cin + ci (channel fastest: the HWIO kernel
//          reshaped to [9*Cin, Cout]),
//          A[m, k] = x[b, ho*s - pad_t + dy, wo*s - pad_l + dx, ci], 0 outside
//   dense  out[m, n] = sum_k x[m, k] W[k, n]
//   then   y[m, n] = float(acc) * (sx[b] * sw[n]) + bias[n]   (f32)
//
// Arithmetic. int8 x int8 products summed in int32 on
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32: exact, in any order (|sum| <=
// 9*Cin*127*127, 2.0e8 at the widest layer). K is padded to a multiple of 32
// with zeros, which adds nothing. The epilogue rounds as the plain version
// does, one operation at a time: __int2float_rn, then __fmul_rn(sx, sw),
// __fmul_rn and __fadd_rn, so no multiply-add is contracted and the output
// equals ops/int8.py `int8_conv_plain` / `int8_dense_plain` bit for bit.
//
// Design (the first, simple form). One block of 128 threads owns a 64 x BN
// output tile (BN = 32 or 64 columns of Cout), four warps of 32 x BN/2. The
// K axis runs in steps of 32: each thread gathers 16 bytes of the A tile (one
// row, half the step) and up to 16 bytes of the W tile, straight from device
// memory into shared memory. Where Cin % 16 == 0 (every conv but a network's
// first) a 16-byte chunk of k lies in one tap and is one 16-byte load;
// otherwise (K = 9 at the first conv) bytes are gathered one by one. W is
// read as stored, [K, N], and written into shared memory transposed to
// [n][k], the B operand's layout. Shared rows are 48 bytes apart (32 used), so
// the fragments' 32-bit reads of eight rows hit eight bank groups. The
// epilogue masks the ragged row and column edges. Bound: at B = 1024 every
// layer of the default encoder moves more bytes (int8 in, f32 out) than its
// ~1.8-58 G int8 operations take at the tensor cores' 1979 TOP/s, so the
// bytes bound it. Not yet: cp.async or TMA staging, a ring of stages, wgmma,
// reuse of the A gather across the column tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // output rows a block
constexpr int BK = 32;       // k a step (one m16n8k32)
constexpr int THREADS = 128; // four warps, 2 x 2
constexpr int LDS = 48;      // bytes between shared rows (32 used)

struct Params {
  const int8_t* x;  // conv: [B, H, W, Cin]; dense: [M, K]
  const int8_t* w;  // [K, N]
  const float* sx;  // [B] (sx_stride 1) or one value (sx_stride 0)
  const float* sw;  // [N]
  const float* bias;  // [N]
  float* out;       // [M, N] f32, or null
  int* out_i32;     // [M, N] the raw sums, or null
  long long M;
  int N, K;
  int H, W, Cin, Wo, stride, pad_t, pad_l;
  long long rows_per_b;  // Ho * Wo (conv), 1 (dense)
  int sx_stride;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One element of the A operand (conv: the implicit im2col; dense: x itself).
template <bool CONV>
__device__ __forceinline__ int8_t a_elem(const Params& p, const int8_t* xb, int h0, int w0, int k) {
  if (k >= p.K) return 0;
  if (!CONV) return xb[k];
  const int tap = k / p.Cin, ci = k - tap * p.Cin;
  const int dy = tap / 3, dx = tap - dy * 3;
  const int h = h0 + dy, w = w0 + dx;
  if (h < 0 || h >= p.H || w < 0 || w >= p.W) return 0;
  return xb[((long long)h * p.W + w) * p.Cin + ci];
}

template <bool CONV, bool VEC_A, bool VEC_B, int BN>
__global__ void __launch_bounds__(THREADS) int8_gemm_kernel(const Params p) {
  constexpr int WN = BN / 2;   // columns a warp
  constexpr int NI = WN / 8;   // n8 tiles a warp
  constexpr int B_CHUNKS = BK * BN / 16;  // 16-byte chunks of the W tile
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // this thread's A row and half step
  const int ar = tid >> 1, ac = (tid & 1) * 16;
  const long long am = m0 + ar;
  const bool a_valid = am < p.M;
  const int8_t* xb = p.x;
  int h0 = 0, w0 = 0;
  if (a_valid) {
    const long long b = am / p.rows_per_b;
    if (CONV) {
      const long long rem = am - b * p.rows_per_b;
      const int ho = (int)(rem / p.Wo), wo = (int)(rem - (long long)ho * p.Wo);
      h0 = ho * p.stride - p.pad_t;
      w0 = wo * p.stride - p.pad_l;
      xb = p.x + b * (long long)p.H * p.W * p.Cin;
    } else {
      xb = p.x + am * p.K;
    }
  }
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
  const int k_pad = (p.K + BK - 1) / BK * BK;
  for (int k0 = 0; k0 < k_pad; k0 += BK) {
    // A tile: 64 rows x 32 k
    {
      const int k = k0 + ac;
      int4 v = make_int4(0, 0, 0, 0);
      if (VEC_A) {
        if (a_valid && k < p.K) {
          if (CONV) {
            const int tap = k / p.Cin, ci = k - tap * p.Cin;
            const int dy = tap / 3, dx = tap - dy * 3;
            const int h = h0 + dy, w = w0 + dx;
            if (h >= 0 && h < p.H && w >= 0 && w < p.W)
              v = *reinterpret_cast<const int4*>(xb + ((long long)h * p.W + w) * p.Cin + ci);
          } else {
            v = *reinterpret_cast<const int4*>(xb + k);
          }
        }
      } else if (a_valid) {
        int8_t* vb = reinterpret_cast<int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < 16; ++j) vb[j] = a_elem<CONV>(p, xb, h0, w0, k + j);
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

  // epilogue: rows g and g + 8 of each m16 tile, columns 2*t4 and 2*t4 + 1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm + i * 16 + g + half * 8;
      if (m >= p.M) continue;
      const float sxb = p.out ? p.sx[(m / p.rows_per_b) * p.sx_stride] : 0.f;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + t4 * 2 + e;
          if (n >= p.N) continue;
          const int s = acc[i][j][half * 2 + e];
          if (p.out_i32) p.out_i32[m * p.N + n] = s;
          if (p.out) {
            const float scale = __fmul_rn(sxb, p.sw[n]);
            p.out[m * p.N + n] = __fadd_rn(__fmul_rn(__int2float_rn(s), scale), p.bias[n]);
          }
        }
      }
    }
  }
}

template <bool CONV, bool VEC_A, bool VEC_B>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const long long mt = (p.M + BM - 1) / BM;
  if (p.N <= 32) {
    const dim3 grid((unsigned)mt, (p.N + 31) / 32);
    int8_gemm_kernel<CONV, VEC_A, VEC_B, 32><<<grid, THREADS, 0, st>>>(p);
  } else {
    const dim3 grid((unsigned)mt, (p.N + 63) / 64);
    int8_gemm_kernel<CONV, VEC_A, VEC_B, 64><<<grid, THREADS, 0, st>>>(p);
  }
  return cudaGetLastError();
}

template <bool CONV>
cudaError_t dispatch(const Params& p, bool vec_a, cudaStream_t st) {
  const bool vec_b = p.N % 16 == 0;
  if (vec_a) return vec_b ? launch<CONV, true, true>(p, st) : launch<CONV, true, false>(p, st);
  return vec_b ? launch<CONV, false, true>(p, st) : launch<CONV, false, false>(p, st);
}

}  // namespace

extern "C" {

// 3x3 conv, NHWC int8 x [B, H, W, Cin], HWIO int8 w as [9*Cin, Cout], output
// [B, Ho, Wo, Cout] (f32 `out` and / or int32 `out_i32`; either may be null).
// Returns the cudaError_t of the launch (0 = success).
int int8_conv_launch(const void* x, const void* w, const float* sx, int sx_stride, const float* sw,
                     const float* bias, float* out, int* out_i32, int B, int H, int W, int Cin, int Cout,
                     int Ho, int Wo, int stride, int pad_t, int pad_l, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || Ho < 1 || Wo < 1 || stride < 1 ||
      (out == nullptr && out_i32 == nullptr) || (long long)B * Ho * Wo / BM >= (1LL << 31) ||
      (Cout + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = static_cast<const int8_t*>(x); p.w = static_cast<const int8_t*>(w);
  p.sx = sx; p.sx_stride = sx_stride; p.sw = sw; p.bias = bias; p.out = out; p.out_i32 = out_i32;
  p.M = (long long)B * Ho * Wo; p.N = Cout; p.K = 9 * Cin;
  p.H = H; p.W = W; p.Cin = Cin; p.Wo = Wo; p.stride = stride; p.pad_t = pad_t; p.pad_l = pad_l;
  p.rows_per_b = (long long)Ho * Wo;
  return (int)dispatch<true>(p, Cin % 16 == 0, (cudaStream_t)stream);
}

// dense: int8 x [M, K] times int8 w [K, N], output [M, N].
int int8_dense_launch(const void* x, const void* w, const float* sx, int sx_stride, const float* sw,
                      const float* bias, float* out, int* out_i32, int M, int K, int N, void* stream) {
  if (M < 1 || K < 1 || N < 1 || (out == nullptr && out_i32 == nullptr) || (N + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = static_cast<const int8_t*>(x); p.w = static_cast<const int8_t*>(w);
  p.sx = sx; p.sx_stride = sx_stride; p.sw = sw; p.bias = bias; p.out = out; p.out_i32 = out_i32;
  p.M = M; p.N = N; p.K = K; p.rows_per_b = 1;
  return (int)dispatch<false>(p, K % 16 == 0, (cudaStream_t)stream);
}

}  // extern "C"
