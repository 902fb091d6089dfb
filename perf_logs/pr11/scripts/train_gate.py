"""Which gates of the sharded train step can fail: the sharded step over
(2 data x 2 model) shards of one card against the unsharded step at full
width (default VAEConfig, B = 64, f32), two steps, for two optimizer
settings, the JAX suite's (lr 0, then 1e-3) on four random batches, and
the same with the gradient reduction broken on purpose.

For each run it prints, a step at a time, the loss's relative difference
and the gradients' (AdamW's first moment, the largest |diff| over each
tensor's max), and after the last step how many parameter elements lie
outside rtol 2e-3 / atol 2e-4 and the largest |diff|.

    python perf_logs/pr11/scripts/train_gate.py
"""

import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

from anuraxla_torch.constants import DEFAULT_MEL  # noqa: E402
from anuraxla_torch.models.train import TrainConfig, create_train_state, make_train_step, step_noise  # noqa: E402
from anuraxla_torch.models.vae import VAEConfig  # noqa: E402
from anuraxla_torch.ops.frontend import log_mel_batch, mel_to_encoder_input  # noqa: E402
from anuraxla_torch.parallel import mesh as pmesh  # noqa: E402
from anuraxla_torch.parallel import train_sharded  # noqa: E402
from anuraxla_torch.probes.common import card_line  # noqa: E402

B, STEPS = 64, 2
psum = train_sharded.psum


@contextlib.contextmanager
def broken(kind):
    """The sharded step's gradient reduction, broken on purpose."""
    if kind == "no /nd":
        train_sharded.psum = lambda parts, mesh: psum(parts, mesh) * mesh.shape["data"]
    elif kind == "shard 1 left out":
        train_sharded.psum = lambda parts, mesh: psum([parts[0]] * len(parts), mesh)
    try:
        yield
    finally:
        train_sharded.psum = psum


def run(lr, warmup, kind=None, seed=0):
    vcfg = VAEConfig()
    tc = TrainConfig(learning_rate=lr, warmup_steps=warmup, beta=0.25, kl_delay_steps=0, kl_warmup_steps=0, seed=0)
    g = torch.Generator(device="cuda").manual_seed(seed)
    audio = 0.1 * torch.randn((B, DEFAULT_MEL.num_samples), generator=g, device="cuda")
    x = mel_to_encoder_input(log_mel_batch(audio, DEFAULT_MEL))
    _, plain = create_train_state(vcfg, tc)
    _, state = create_train_state(vcfg, tc)
    mesh = pmesh.make_mesh(devices=["cuda:0"] * 4, model_axis=2)
    ss, _ = train_sharded.shard_state(state, mesh)
    step_a = make_train_step(tc.beta)
    out = {"lr": lr, "warmup": warmup, "broken": kind, "seed": seed, "steps": []}
    with broken(kind):
        step_b = train_sharded.make_sharded_train_step(tc.beta, mesh)
        for i in range(STEPS):
            eps = step_noise(seed, i, (B, vcfg.latent_dim), "cuda")
            plain, pm = step_a(plain, x, eps)
            ss, sm = step_b(ss, x, eps)
            pa, pb = dict(plain.model.named_parameters()), dict(ss.state.model.named_parameters())
            ma = {k: plain.optimizer.state[pa[k]]["exp_avg"] for k in pa}
            mb = {k: ss.state.optimizer.state[pb[k]]["exp_avg"] for k in pb}
            grad = max(float((mb[k] - ma[k]).abs().max() / ma[k].abs().max().clamp_min(1e-30)) for k in pa)
            out["steps"].append({"loss_rel": abs(float(sm["loss"]) / float(pm["loss"]) - 1), "grad_err": grad})
    n_out, n_all, dmax = 0, 0, 0.0
    for k in pa:
        a, b = pa[k].detach(), pb[k].detach()
        d = (b - a).abs()
        n_out += int((d > 2e-4 + 2e-3 * a.abs()).sum())
        n_all += a.numel()
        dmax = max(dmax, float(d.max()))
    out.update(params_outside=n_out, params=n_all, params_max_abs_diff=dmax)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    print(card_line(), torch.cuda.get_device_name(0), flush=True)
    run(1e-3, 0)
    for seed in range(4):
        run(1e-3, 1, seed=seed)
    for kind in ("no /nd", "shard 1 left out"):
        run(1e-3, 0, kind)
