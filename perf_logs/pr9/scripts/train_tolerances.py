"""The readings behind the training tests' bf16 tolerances.

    python perf_logs/pr9/scripts/train_tolerances.py jax    # CPU; needs jax (the JAX package)
    python perf_logs/pr9/scripts/train_tolerances.py card   # the card against the CPU; no jax

``jax``: the small config of tests/test_torch_train.py, four seeds, both
downsample families, beta 0 and 0.3. For each gradient leaf: |port bf16 -
JAX bf16| and |JAX bf16 - JAX f32| over the leaf's max; then three AdamW steps
(warmup 1) as test_three_adamw_steps_match_jax runs them, with the share of
parameters beyond each candidate rule.

``card``: test_train_steps_on_card_match_cpu's config and steps, the card
against the CPU: loss, the worst gradient of biases and of the rest over
their tensor's max, and the share of parameters beyond each rule.
"""
import dataclasses
import sys
from pathlib import Path

root = Path(__file__).resolve().parents[3]
sys.path[:0] = [str(root), str(root / "tests")]
import numpy as np
import torch


def shares(d, scale, lr):
    return (f"beyond 1e-5+1e-4|p| {np.mean(d > 1e-5 + 1e-4 * scale):.4%}, beyond 1e-5+1e-2|p| "
            f"{np.mean(d > 1e-5 + 1e-2 * scale):.4%}, beyond lr/4 {np.mean(d > lr / 4):.4%}, max |d| {d.max():.3e}")


def jax_readings():
    import jax
    import jax.numpy as jnp

    import test_torch_train as T
    from test_torch_train import SMALL, j_train, j_vae, t_convert, t_train, t_vae

    worst = {"bias": (0.0, 0.0), "other": (0.0, 0.0)}
    for downsample in ("stride", "avgpool"):
        for beta in (0.0, 0.3):
            for seed in (12, 22, 32, 42):
                kw = dict(SMALL, downsample=downsample)
                x, key = T._x((4, 16, 16, 1), seed=seed + 1), jax.random.PRNGKey(seed + 2)
                grads = {}
                for dt in (jnp.float32, jnp.bfloat16):
                    vae, params = j_vae.init_vae(j_vae.VAEConfig(**kw, dtype=dt), seed=seed)
                    _, g = jax.value_and_grad(lambda p: j_train.vae_loss(vae, p, jnp.asarray(x), key, beta),
                                              has_aux=True)(params)
                    grads[dt] = jax.tree_util.tree_leaves_with_path(T._np(g))
                tcfg = t_vae.VAEConfig(**kw, dtype="bfloat16")
                model = t_vae.ConvVAE(tcfg)
                model.load_state_dict(t_convert.state_from_jax(T._np(params), t_convert.vae_slots(tcfg)))
                loss, _ = t_train.vae_loss(model, torch.from_numpy(x), torch.from_numpy(T._eps(key, (4, 8))), beta)
                loss.backward()
                got = jax.tree_util.tree_leaves(t_convert.params_for_jax(
                    {k: p.grad for k, p in model.named_parameters()}, t_convert.vae_slots(tcfg)))
                for (path, r), (_, f), g in zip(grads[jnp.bfloat16], grads[jnp.float32], got):
                    kind = "bias" if jax.tree_util.keystr(path).endswith("['bias']") else "other"
                    mx = np.abs(r).max()
                    w = worst[kind]
                    worst[kind] = (max(w[0], np.abs(g - r).max() / mx), max(w[1], np.abs(r - f).max() / mx))
    for kind, (port, ref) in worst.items():
        print(f"bf16 gradients, {kind}: port vs JAX worst {port:.4f} of the tensor's max; JAX bf16 vs JAX f32 "
              f"worst {ref:.4f}")
    for downsample in ("stride", "avgpool"):
        for bf16 in (False, True):
            kw = dict(SMALL, downsample=downsample)
            jtc = j_train.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, beta=0.1,
                                      kl_delay_steps=1, kl_warmup_steps=2)
            ttc = t_train.TrainConfig(**dataclasses.asdict(jtc))
            jcfg = j_vae.VAEConfig(**kw, dtype=jnp.bfloat16 if bf16 else jnp.float32)
            tcfg = t_vae.VAEConfig(**kw, dtype="bfloat16" if bf16 else "float32")
            vae, state = j_train.create_train_state(jcfg, jtc)
            _, ts = t_train.create_train_state(tcfg, ttc, device="cpu", init_params=t_convert.state_from_jax(
                T._np(state.params), t_convert.vae_slots(tcfg)))
            jstep = jax.jit(j_train.make_train_step(vae, jtc.beta, jtc.kl_warmup_steps, jtc.kl_delay_steps))
            tstep = t_train.make_train_step(ttc.beta, ttc.kl_warmup_steps, ttc.kl_delay_steps)
            key = jax.random.PRNGKey(3)
            for k in range(3):
                batch = T._x((4, 16, 16, 1), seed=20 + k)
                state, _ = jstep(state, jnp.asarray(batch), key)
                ts, _ = tstep(ts, torch.from_numpy(batch), torch.from_numpy(T._eps(jax.random.fold_in(key, k), (4, 8))))
            got = jax.tree_util.tree_leaves(t_convert.params_for_jax(ts.model.state_dict(), t_convert.vae_slots(tcfg)))
            ref = jax.tree_util.tree_leaves(T._np(state.params))
            d = np.concatenate([np.abs(g - r).ravel() for g, r in zip(got, ref)])
            print(f"3 AdamW steps, {downsample}, {'bf16' if bf16 else 'f32'}: "
                  + shares(d, np.concatenate([np.abs(r).ravel() for r in ref]), jtc.learning_rate))


def card_readings():
    from anuraxla_torch.models.train import TrainConfig, create_train_state, make_train_step
    from anuraxla_torch.models.vae import VAEConfig
    from anuraxla_torch.probes.common import card_line

    print(card_line())
    for downsample in ("stride", "avgpool"):
        for dtype in ("float32", "bfloat16"):
            cfg = VAEConfig(latent_dim=8, widths=(8, 16), dense_width=32, groups=4, input_hw=(48, 32),
                            downsample=downsample, dtype=dtype)
            tc = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10, beta=0.25, kl_delay_steps=1,
                             kl_warmup_steps=2)
            rng = np.random.default_rng(13)
            batches = [torch.from_numpy(rng.standard_normal((6, 48, 32, 1)).astype(np.float32)) for _ in range(3)]
            eps = [torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32)) for _ in range(3)]
            step = make_train_step(tc.beta, tc.kl_warmup_steps, tc.kl_delay_steps)
            out = {}
            for dev in ("cpu", "cuda"):
                _, st = create_train_state(cfg, tc, device=dev)
                losses = [float(step(st, b.to(dev), e.to(dev))[1]["loss"]) for b, e in zip(batches, eps)]
                out[dev] = (np.array(losses), {k: p.grad.cpu() for k, p in st.model.named_parameters()},
                            {k: v.cpu() for k, v in st.model.state_dict().items()})
            (lc, gc, pc), (lg, gg, pg) = out["cpu"], out["cuda"]
            g = {kind: max(float((gg[k] - gc[k]).abs().max() / gc[k].abs().max()) for k in gc
                           if k.endswith("bias") == (kind == "bias")) for kind in ("bias", "other")}
            d = torch.cat([(pg[k] - pc[k]).abs().ravel() for k in pc]).numpy()
            scale = torch.cat([pc[k].abs().ravel() for k in pc]).numpy()
            print(f"{downsample} {dtype}: loss rel {np.abs(lg / lc - 1).max():.3e}; gradients of the tensor's max: "
                  f"biases {g['bias']:.4f}, the rest {g['other']:.4f}; params " + shares(d, scale, tc.learning_rate))


if __name__ == "__main__":
    {"jax": jax_readings, "card": card_readings}[sys.argv[1]]()
