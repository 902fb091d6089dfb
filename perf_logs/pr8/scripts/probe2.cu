// launch diagnostics of the split kernel: attributes and occupancy, step by step
#include "../anuraxla_torch/csrc/mel_power_ct_split.cu"
#include <stdio.h>
extern "C" int diag(int bf16, int smem, int cluster) {
  auto kernel = bf16 ? mel_power_ct_split_kernel<false> : mel_power_ct_split_kernel<true>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  printf("[diag] bf16=%d attrs err=%d regs=%d local=%zu static_smem=%zu maxDyn=%d maxThreads=%d\n", bf16, (int)e,
         a.numRegs, a.localSizeBytes, a.sharedSizeBytes, a.maxDynamicSharedSizeBytes, a.maxThreadsPerBlock);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  printf("[diag] set smem %d err=%d %s\n", smem, (int)e, cudaGetErrorString(e));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(4, cluster, 1); cfg.blockDim = dim3(NTHREADS, 1, 1); cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1; attr[0].val.clusterDim.y = cluster; attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr; cfg.numAttrs = 1;
  int n = -1;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  printf("[diag] max active clusters err=%d %s n=%d\n", (int)e, cudaGetErrorString(e), n);
  fflush(stdout);
  return (int)e;
}
