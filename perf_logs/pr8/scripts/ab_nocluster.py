"""A/B timing of two split-kernel sources at B = 1024, in turn (a, b, b, a):
the source with the cluster path, launched in clusters of 1, against the
source without it. Run from the root of a checkout:
python perf_logs/pr8/scripts/ab_nocluster.py name=path.cu ... (a source whose
launch takes a cluster argument gets 1; `name=path.cu+clusterlaunch` launches
a source without it through cudaLaunchKernelEx with a cluster dimension of 1,
the launch of the source with it)."""
import ctypes, subprocess, sys, numpy as np, torch
from concurrent.futures import ThreadPoolExecutor
sys.path.insert(0, ".")
from anuraxla_torch.constants import DEFAULT_MEL as cfg
from anuraxla_torch.ops import mel_kernel as tk
from anuraxla_torch.ops.frontend import rms_scale_batch
from anuraxla_torch.probes.common import cuda_ms

srcs = dict(a.split("=") for a in sys.argv[1:])
patch = {n: p.endswith("+clusterlaunch") for n, p in srcs.items()}
srcs = {n: p.removesuffix("+clusterlaunch") for n, p in srcs.items()}
has_cluster = {n: "int cluster" in open(p).read() for n, p in srcs.items()}
PLAIN_LAUNCH = "  kernel<<<dim3((T + TF - 1) / TF, B), NTHREADS, (size_t)smem, (cudaStream_t)stream>>>(p);\n"
CLUSTER_LAUNCH = """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((T + TF - 1) / TF, B, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
"""


def build(item):
    name, path = item
    text = open(path).read().replace('#include "mel_', '#include "../anuraxla_torch/csrc/mel_')
    if patch[name]:
        assert text.count(PLAIN_LAUNCH) == 1
        text = text.replace(PLAIN_LAUNCH, CLUSTER_LAUNCH)
    open(f"_proof/ab_{name}.cu", "w").write(text)
    r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", f"_proof/libab_{name}.so",
                        f"_proof/ab_{name}.cu"], capture_output=True, text=True)
    regs = [l.strip() for l in r.stderr.splitlines() if "Used" in l or "spill" in l]
    return name, r.returncode, r.stderr[-1500:] if r.returncode else regs


with ThreadPoolExecutor(8) as ex:
    for name, rc, info in ex.map(build, srcs.items()):
        print(f"[ab build] {name} rc={rc} cluster argument={has_cluster[name]} {info}", flush=True)
vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
libs = {}
for n in srcs:
    f = ctypes.CDLL(f"_proof/libab_{n}.so").mel_power_ct_split_launch
    f.argtypes = [vp, i64, vp, vp, vp, vp, vp, *[i32] * (10 if has_cluster[n] else 9), vp]
    libs[n] = f
B = 1024
rng = np.random.default_rng(0)
y = torch.from_numpy((0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)).cuda()
s = rms_scale_batch(y)
pad = cfg.n_fft // 2
for exact, first, T in ((True, 0, 626), (False, 217, 192)):
    tab, win, wr = tk._tables(cfg, y.device, "ct_fused", exact)
    stages = tk.ct_fused_tile(cfg.n_fft, cfg.hop_length, exact)[1]
    out = torch.empty(B, T, cfg.n_mels, device="cuda")
    small = tk.mel_power_ct_fused_plain(torch.nn.functional.pad(y[:4], (pad, pad)), s[:4], cfg, T,
                                        first_frame=first, exact=exact)
    for n in list(srcs) + list(srcs)[::-1]:
        tail = [stages, 1] if has_cluster[n] else [stages]

        def go():
            e = libs[n](y.data_ptr(), y.shape[1], s.data_ptr(), tab.data_ptr(), win.data_ptr(), wr.data_ptr(),
                        out.data_ptr(), B, T, first, pad, cfg.n_fft, cfg.hop_length, cfg.n_mels, *tail,
                        int(not exact), torch.cuda.current_stream().cuda_stream)
            assert e == 0, e
        ms = cuda_ms(go, iters=5)
        rel = ((out[:4] - small).abs() / small.abs().amax(dim=(1, 2), keepdim=True)).max().item()
        print(f"[ab] {n} exact={exact} frames {first}..{first + T - 1}: {ms:.3f} ms, worst vs plain (4 rows) {rel:.3e}",
              flush=True)
