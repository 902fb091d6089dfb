// Window expansion: a batch's PCM16 source runs -> [B, row_len] f32 rows.
//
// Replaces no TPU kernel. The JAX package cuts a soundscape's analysis
// windows on the host (`anuraxla/pipeline/stream.py` `fleet_window_batches`)
// and ships every window as its own row; consecutive windows overlap (5 s
// windows at a 2.5 s hop), so each source sample is converted and crossed
// the link twice, as f32. Here the host ships each batch's samples once, as
// raw int16 runs (`pipeline/stream.py` `fleet_span_batches`), and this kernel
// cuts the rows on the card:
//
//   rows[j, col + t] = runs[off_j + t] / 32768    for t < len_j
//   rows[j, c]       = 0                          elsewhere
//
// The slot the host sends holds the table first ([B] int2 = (off_j, len_j);
// rows past the batch's windows have len 0), then the runs. `/ 32768` is a
// multiplication by 2^-15, exact in f32, so the rows are bitwise those of
// `WavStream.read` and of the int16 link's `x.to(f32) / 32768`.
//
// Bound: bytes. The rows are written once (4 B a column), the runs read
// about (row_len / hop) times from L2 (2 B a sample); at B = 1024 x 240 000
// about 1.0 GB moved, ~0.3 ms at 3.35 TB/s. Design: one block row a batch
// row, each thread four consecutive columns, stored as one 16-byte float4
// where the row length allows it (row_len % 4 == 0), the int16 reads at any
// offset left to the L1 (a warp reads 256 contiguous bytes).
//
// ops/window_expand.py `window_expand_plain` is this function in PyTorch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 4;  // columns a thread

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
window_expand_kernel(const int2* __restrict__ table, const int16_t* __restrict__ runs,
                     float* __restrict__ rows, int row_len, int col) {
  const int j = blockIdx.y;
  const int c0 = (blockIdx.x * THREADS + threadIdx.x) * COLS;
  if (c0 >= row_len) return;
  const int2 t = table[j];
  const int16_t* src = runs + t.x;
  float* dst = rows + (long long)j * row_len;
  float v[COLS];
#pragma unroll
  for (int e = 0; e < COLS; ++e) {
    const int i = c0 + e - col;
    v[e] = (i >= 0 && i < t.y) ? (float)src[i] * (1.0f / 32768.0f) : 0.0f;
  }
  if (VEC) {
    *reinterpret_cast<float4*>(dst + c0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < COLS; ++e)
      if (c0 + e < row_len) dst[c0 + e] = v[e];
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `slot`: the B table entries (int2, 8 B each) followed by the int16 runs.
// `rows`: [B, row_len] f32, 16-byte aligned.
int window_expand_launch(const void* slot, int B, int row_len, int col, float* rows, void* stream) {
  if (B < 1 || B > 65535 || row_len < 1 || col < 0 || col >= row_len)
    return (int)cudaErrorInvalidValue;
  const int2* table = static_cast<const int2*>(slot);
  const int16_t* runs = reinterpret_cast<const int16_t*>(table + B);
  const int per_block = THREADS * COLS;
  const dim3 grid((row_len + per_block - 1) / per_block, B);
  const cudaStream_t st = (cudaStream_t)stream;
  if (row_len % COLS == 0)
    window_expand_kernel<true><<<grid, THREADS, 0, st>>>(table, runs, rows, row_len, col);
  else
    window_expand_kernel<false><<<grid, THREADS, 0, st>>>(table, runs, rows, row_len, col);
  return (int)cudaGetLastError();
}

}  // extern "C"
