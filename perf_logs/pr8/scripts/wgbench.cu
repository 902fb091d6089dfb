// wgmma throughput by operand layout: 4 warpgroups, each loops over ITERS stages of
// 3 chained m64nNk16 products from shared memory (A: its own 64 rows; B: shared), wait each stage.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)mode << 62);
}
template <int N> struct W;
template <> struct W<32> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int z) {
    asm volatile("{\n .reg .pred p;\n setp.eq.u32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3]),"+f"(d[4]),"+f"(d[5]),"+f"(d[6]),"+f"(d[7]),"+f"(d[8]),"+f"(d[9]),"+f"(d[10]),"+f"(d[11]),"+f"(d[12]),"+f"(d[13]),"+f"(d[14]),"+f"(d[15])
      : "l"(a), "l"(b), "r"(z) : "memory");
  }
};
template <> struct W<64> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int z) {
    asm volatile("{\n .reg .pred p;\n setp.eq.u32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3]),"+f"(d[4]),"+f"(d[5]),"+f"(d[6]),"+f"(d[7]),"+f"(d[8]),"+f"(d[9]),"+f"(d[10]),"+f"(d[11]),"+f"(d[12]),"+f"(d[13]),"+f"(d[14]),"+f"(d[15]),
        "+f"(d[16]),"+f"(d[17]),"+f"(d[18]),"+f"(d[19]),"+f"(d[20]),"+f"(d[21]),"+f"(d[22]),"+f"(d[23]),"+f"(d[24]),"+f"(d[25]),"+f"(d[26]),"+f"(d[27]),"+f"(d[28]),"+f"(d[29]),"+f"(d[30]),"+f"(d[31])
      : "l"(a), "l"(b), "r"(z) : "memory");
  }
};
template <int N, int CHAIN>
__global__ void __launch_bounds__(512, 1) bench(float* out, long long* cyc, int iters, uint32_t lbo, uint32_t sbo, uint32_t mode) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ uint64_t bars[2];
  const int flags = (int)mode >> 4;  // 1: try_wait a completed barrier each stage; 2: arrive each stage (lane 0 of each warp)
  mode &= 3;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"((uint32_t)__cvta_generic_to_shared(&bars[0])), "r"(1));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"((uint32_t)__cvta_generic_to_shared(&bars[1])), "r"((1 << 20) - 1));
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"((uint32_t)__cvta_generic_to_shared(&bars[0])));
  }
  for (int i = threadIdx.x; i < 65536 / 4; i += 512) ((uint32_t*)smem)[i] = 0x3f803f80u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const uint32_t a = base + (it & 3) * 16384 + wg * 2048, b = base + 65536 - 4096 + (it & 1) * 1024;
    if (flags & 1) {
      uint32_t ok = 0;
      while (!ok)
        asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(ok) : "r"((uint32_t)__cvta_generic_to_shared(&bars[0])), "r"(0u) : "memory");
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int c = 0; c < CHAIN; ++c) W<N>::mma(d, desc(a + (c & 1) * 8192, lbo, sbo, mode), desc(b, lbo, sbo, mode), c == 0);
    asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if ((flags & 2) && (threadIdx.x & 31) == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"((uint32_t)__cvta_generic_to_shared(&bars[1])) : "memory");
    if (flags & 4) {
#pragma unroll
      for (int i = 0; i < 16; ++i) d[16 + i] += d[i];
    }
  }
  long long t1 = clock64();
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * 512 + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
extern "C" int run(int n, int chain, int mode, int iters, float* out, long long* cyc) {
  uint32_t lbo = 128, sbo = 256;
  if (mode == 3) lbo = 16;  // 32B swizzle: leading offset unused for K-major
  auto k = n == 32 ? (chain == 3 ? bench<32, 3> : bench<32, 1>) : (chain == 3 ? bench<64, 3> : bench<64, 1>);
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  k<<<132, 512, 65536>>>(out, cyc, iters, lbo, sbo, mode);
  return (int)cudaDeviceSynchronize();
}
