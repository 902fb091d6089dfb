"""The VAE train step on the card — the port of ``scripts/probe_train.py``:
steps/s and examples/s of the β-VAE step (forward, backward, AdamW) at the
default ``VAEConfig`` for each batch size, so a deployment can decide where
training belongs.

The first step of each batch size is timed on its own (host clock, ended by
a synchronize): it holds the one-time set-up — cuDNN's and cuBLAS's handles
and algorithm choice, the allocator's first blocks — that the reference's
``compile_s`` holds for its compile. Then ``--steps`` steps run back to back
(the state threads through them in place) between two CUDA events: the
steady state, the device's time with the host's launches as they come. On
``--device cpu`` both are host-clock times of the CPU and say nothing of the
card.

    python -m anuraxla_torch.probes.train_step [--batches 64,256] [--steps 40] [--device cpu]

Prints one JSON line per batch size: ``batch``, ``ms_per_step``,
``steps_per_s``, ``chunks_per_s``, ``first_step_s``, ``first_loss``,
``final_loss``; a batch size that fails (out of memory) prints its error.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from anuraxla_torch import resolve_device
from anuraxla_torch.models.train import TrainConfig, create_train_state, make_train_step
from anuraxla_torch.models.vae import VAEConfig
from anuraxla_torch.probes.common import device_header, emit


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batches", type=str, default="64,256")
    p.add_argument("--steps", type=int, default=40, help="timed steps per batch size")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu (a smoke test)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"

    cfg, tc = VAEConfig(), TrainConfig()
    T, M = cfg.input_hw
    emit({**device_header(dev), "widths": list(cfg.widths), "latent": cfg.latent_dim})

    def sync():
        if on_card:
            torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    for B in [int(b) for b in args.batches.split(",")]:
        _, state = create_train_state(cfg, tc, device=dev)
        step = make_train_step(tc.beta, tc.kl_warmup_steps, tc.kl_delay_steps, seed=tc.seed)
        batch = torch.from_numpy(rng.standard_normal((B, T, M, 1)).astype(np.float32)).to(dev)
        t0 = time.perf_counter()
        try:
            state, metrics = step(state, batch)
            first_loss = float(metrics["loss"])  # waits for the step
        except torch.OutOfMemoryError as e:  # a batch size that does not fit is a result
            emit({"batch": B, "error": f"{type(e).__name__}: {e}"[:300]})
            del state
            continue
        first_s = time.perf_counter() - t0

        n = args.steps
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            state, metrics = step(state, batch)
        if on_card:
            end.record()
        sync()
        ms = start.elapsed_time(end) / n if on_card else (time.perf_counter() - t0) * 1e3 / n
        emit({"batch": B, "ms_per_step": ms, "steps_per_s": 1e3 / ms, "chunks_per_s": B * 1e3 / ms,
              "first_step_s": first_s, "first_loss": first_loss, "final_loss": float(metrics["loss"])})
        del state, batch


if __name__ == "__main__":
    main()
