// wgmma m64n32k16 with no-swizzle K-major descriptors (LBO along K, SBO along M/N),
// and a multicast bulk copy across a cluster
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
__global__ void wg(const uint16_t* a, const uint16_t* b, float* d, int lbo, int sbo) {
  __shared__ __align__(128) uint16_t sa[64 * 16], sb[32 * 16];
  for (int i = threadIdx.x; i < 64 * 16; i += 128) sa[i] = a[i];
  for (int i = threadIdx.x; i < 32 * 16; i += 128) sb[i] = b[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float acc[16];
  uint64_t da = desc((uint32_t)__cvta_generic_to_shared(sa), lbo, sbo);
  uint64_t db = desc((uint32_t)__cvta_generic_to_shared(sb), lbo, sbo);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]), "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]),
        "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]), "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15])
      : "l"(da), "l"(db), "r"(1u) : "memory");
  asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  for (int j = 0; j < 4; ++j) for (int h = 0; h < 2; ++h) for (int e = 0; e < 2; ++e)
    d[(16 * warp + g + 8 * h) * 32 + 8 * j + 2 * c + e] = acc[4 * j + 2 * h + e];
}
extern "C" int run_wgmma(const void* a, const void* b, float* d, int lbo, int sbo) {
  wg<<<1, 128>>>((const uint16_t*)a, (const uint16_t*)b, d, lbo, sbo);
  return (int)cudaDeviceSynchronize();
}
