#include "../anuraxla_torch/csrc/mel_power_ct_split.cu"
#include <stdio.h>
extern "C" int diag_launch(const float* y, long long L, const void* tab, const float* win, const float* wr, float* out,
                           int T, int n_fft, int hop, int n_mels, int stages, int cluster, int bf16, int use_attr) {
  Params p;
  p.y = y; p.scale = nullptr; p.win = win; p.wr = wr; p.tab = (const uint8_t*)tab; p.out = out; p.L = L;
  p.B = 1; p.T = T; p.n_fft = n_fft; p.hop = hop; p.n_mels = n_mels; p.R = n_fft / NB; p.frame0 = 0;
  p.pad_l = n_fft / 2; p.stages = stages; p.n_stages = n_stages_of(p.R, n_mels, !bf16); p.m_tiles = (n_mels + 63) / 64;
  const long long smem = mel_power_ct_split_smem_bytes(n_fft, hop, stages, bf16);
  auto kernel = bf16 ? mel_power_ct_split_kernel<false> : mel_power_ct_split_kernel<true>;
  cudaError_t e0 = cudaGetLastError();
  cudaError_t e1 = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((T + TF - 1) / TF, cluster, 1); cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem; cfg.stream = 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1; attr[0].val.clusterDim.y = cluster; attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr; cfg.numAttrs = use_attr;
  cudaError_t e2 = cudaLaunchKernelEx(&cfg, kernel, p);
  cudaError_t e3 = cudaGetLastError();
  cudaError_t e4 = cudaDeviceSynchronize();
  printf("[diag3] bf16=%d stages=%d smem=%lld cluster=%d attr=%d: prior=%d set=%d launch=%d(%s) last=%d sync=%d(%s)\n",
         bf16, stages, smem, cluster, use_attr, (int)e0, (int)e1, (int)e2, cudaGetErrorString(e2), (int)e3, (int)e4,
         cudaGetErrorString(e4));
  fflush(stdout);
  return (int)e4;
}
