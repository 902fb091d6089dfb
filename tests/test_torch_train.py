"""The port's training path (``anuraxla_torch.models.{vae,convert,checkpoint,
train}``) held against the JAX package on the CPU, at small size, on the
same params (carried across with ``models.convert``) and the same noise.

Tolerances:
- f32 forwards (encoders, decoders, ConvVAE): rtol 5e-4 / atol 2e-5, the
  encoder tier's (test_torch_encoder.py);
- bf16 trunks: 1e-2 absolute and relative, the bf16 tier's — both sides
  round the same values to bf16 at the same points but sum in another order;
- the loss: rtol 1e-5; every gradient: within 1e-4 of its tensor's largest
  magnitude (f32 sums in another order through a backward pass);
- with a bf16 trunk: the loss rtol 1e-2; each gradient within 0.2 of its
  tensor's largest magnitude, and each that is not a bias within 6e-2:
  1.5 times the worst readings (perf_logs/pr9/scripts/train_tolerances.py:
  the port against JAX 0.102 and 0.028 on these configs, the card against
  the CPU 0.135 and 0.042 in test_torch_cuda.py). The bf16 tier's 1e-2
  cannot hold leaf by leaf: JAX's own bf16 gradients lie up to 0.105 of a
  tensor's max from its f32 ones, the most in the biases of the convs that
  feed a GroupNorm and of the output conv, whose gradients are sums that
  cancel. A zero gradient (1.0) or one off by a scale of 2 (0.5) fails both;
- the schedule: 1e-9 absolute (optax computes it in f32 of values ~1e-3);
  β_t: rtol 1e-5 against the β JAX's step applied, (loss - recon) / kl;
- parameters after k AdamW steps: Adam divides each gradient by its own
  magnitude, so an element whose gradient sits at rounding level moves by up
  to ~lr either way in either package. In f32 all but 1 % of the elements
  are held within rtol 1e-4 / atol 1e-5. With a bf16 trunk that rule cannot
  hold (12–16 % of the elements fall beyond it): the gradients differ by up
  to a few % of a tensor's max, and Adam turns that into a step difference
  in units of lr, not of |p|. There all but 1 % are held within lr/4
  (measured: 0.03–0.12 % beyond here, 0.29–0.34 % on the card). Adam's update does not see a gradient's
  scale, so a wrong scale shows only in the gradient tests;
- artifacts across the packages: bitwise; resume on the CPU: bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anuraxla.models import checkpoint as j_ckpt
from anuraxla.models import train as j_train
from anuraxla.models import vae as j_vae
from anuraxla_torch.models import checkpoint as t_ckpt
from anuraxla_torch.models import convert as t_convert
from anuraxla_torch.models import train as t_train
from anuraxla_torch.models import vae as t_vae

SMALL = dict(latent_dim=8, widths=(8,), dense_width=16, groups=4, input_hw=(16, 16))
# two blocks and an odd input: the stride family's bottleneck rounds up, the
# avgpool family's down, so neither decoder returns the input size
ODD = dict(latent_dim=8, widths=(8, 16), dense_width=16, groups=4, input_hw=(45, 30))
F32 = dict(rtol=5e-4, atol=2e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, dtype=np.float32), tree)


def _pair(kw, seed=1, spec=None):
    """A flax ConvVAE and the port's on the same params."""
    jcfg, tcfg = j_vae.VAEConfig(**kw), t_vae.VAEConfig(**kw)
    jspec = None if spec is None else j_vae.DecoderSpec(**spec)
    tspec = None if spec is None else t_vae.DecoderSpec(**spec)
    vae, params = j_vae.init_vae(jcfg, seed=seed, decoder_spec=jspec)
    model = t_vae.ConvVAE(tcfg, tspec)
    model.load_state_dict(t_convert.state_from_jax(_np(params), t_convert.vae_slots(tcfg, tspec)))
    return vae, params, model, tcfg


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _eps(key, shape):
    return np.array(jax.random.normal(key, shape, jnp.float32))  # writable, for torch.from_numpy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [SMALL, ODD], ids=["small", "odd"])
def test_avgpool_encoder_matches_flax(kw, dtype):
    kw = dict(kw, downsample="avgpool", dtype=dtype)
    jcfg = j_vae.VAEConfig(**dict(kw, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32))
    enc, params = j_vae.init_encoder(jcfg, seed=4)
    tcfg = t_vae.VAEConfig(**kw)
    model = t_vae.ConvVAEEncoder(tcfg)
    model.load_state_dict(t_convert.encoder_state_from_jax(_np(params), tcfg))
    assert len(model.blocks[0].state_dict()) == 4  # Conv_0 and GroupNorm_0 only
    x = _x((3, *kw["input_hw"], 1), seed=5)
    ref = enc.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in ("mu", "logvar"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key], np.float32),
                                   **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_avgpool_artifact_from_jax_serves_in_the_port(tmp_path, dtype):
    """An avgpool artifact written by JAX ``save_encoder`` is served by the
    port's ``EncoderSession`` as the JAX package's session serves it."""
    from anuraxla.pipeline.session import EncoderSession as JSession
    from anuraxla_torch.constants import MelConfig
    from anuraxla_torch.pipeline.session import EncoderSession

    mel = dict(sr=16000, duration=0.5, n_mels=32, fmin=100.0, fmax=7500.0, hop_length=128, n_fft=256,
               target_frames=48)
    kw = dict(latent_dim=8, widths=(8, 16), dense_width=32, groups=4, input_hw=(48, 32), downsample="avgpool")
    _, params = j_vae.init_encoder(j_vae.VAEConfig(**kw), seed=6)
    j_ckpt.save_encoder(tmp_path / "enc", j_vae.VAEConfig(**kw), params)
    from anuraxla.constants import MelConfig as JMel

    audio = (0.1 * _x((3, 8000), seed=7))
    want = JSession(mel=JMel(**mel), encoder_dir=tmp_path / "enc", backend="matmul",
                    encoder_dtype=dtype).load().encode_array(audio)
    got = EncoderSession(mel=MelConfig(**mel), encoder_dir=tmp_path / "enc", backend="matmul", device="cpu",
                         encoder_dtype=dtype).load().encode_array(audio)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("downsample", ["stride", "avgpool"])
@pytest.mark.parametrize("kw", [SMALL, ODD], ids=["small", "odd"])
def test_native_decoder_matches_flax(kw, downsample, dtype):
    jkw = dict(kw, downsample=downsample, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    jcfg, tcfg = j_vae.VAEConfig(**jkw), t_vae.VAEConfig(**dict(kw, downsample=downsample, dtype=dtype))
    dec = j_vae.ConvVAEDecoder(jcfg)
    params = dec.init(jax.random.PRNGKey(2), jnp.zeros((1, kw["latent_dim"])))
    model = t_vae.ConvVAEDecoder(tcfg)
    model.load_state_dict(t_convert.state_from_jax(_np(params), t_convert.decoder_slots(tcfg)))
    z = _x((3, kw["latent_dim"]), seed=8)
    ref = np.asarray(dec.apply(params, jnp.asarray(z)), np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(z)).numpy()
    bt, bm = tcfg.bottleneck_hw
    assert got.shape == ref.shape == (3, bt * 2 ** len(kw["widths"]), bm * 2 ** len(kw["widths"]), 1)
    assert got.dtype == np.float32  # the output conv runs f32
    np.testing.assert_allclose(got, ref, **(F32 if dtype == "float32" else BF16))


STACKS = {
    "convt": ((("convt", 8), ("conv", 8), ("convt", 4), ("conv", 1)), (3, 2)),
    "upconv": ((("upconv", 8), ("upconv", 4), ("conv", 1)), (3, 2)),
    "mixed": ((("convt", 6), ("upconv", 4), ("conv", 2)), (2, 3)),
}


def _spec(kind, norm, latent=6):
    stack, hw = STACKS[kind]
    return dict(latent_dim=latent, dense_widths=(20, 12 * hw[0] * hw[1]), bottleneck_hw=hw, bottleneck_c=12,
                stack=stack, norm=norm, groups=2, gn_eps=1e-5)


@pytest.mark.parametrize("norm", ["group", "none"])
@pytest.mark.parametrize("kind", list(STACKS))
def test_ingested_decoder_from_jax_artifact(tmp_path, kind, norm):
    """Spec and weights written by JAX ``save_decoder``, read by the port's
    ``load_decoder``; the GroupNorm affines are moved off 1/0 so they count."""
    jspec = j_vae.DecoderSpec(**_spec(kind, norm))
    dec, params = j_vae.init_ingested_decoder(jspec, seed=3)
    params = jax.tree_util.tree_map(lambda a: a + 0.1 * _x(a.shape, seed=a.size), params)
    j_ckpt.save_decoder(tmp_path / "dec", jspec, params)
    state, spec = t_ckpt.load_decoder(tmp_path / "dec")
    assert spec == t_vae.DecoderSpec(**_spec(kind, norm))
    model = t_vae.IngestedDecoder(spec)
    model.load_state_dict(state)
    z = _x((3, 6), seed=9)
    ref = np.asarray(dec.apply(params, jnp.asarray(z)))
    with torch.no_grad():
        got = model(torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == (3, *spec.out_hw, spec.out_channels)
    np.testing.assert_allclose(got, ref, **F32)


@pytest.mark.parametrize("decoder", ["native", "ingested"])
@pytest.mark.parametrize("downsample", ["stride", "avgpool"])
def test_convvae_forward_with_jax_eps(downsample, decoder):
    kw = dict(SMALL, downsample=downsample)
    spec = dataclasses.asdict(_bad()) if decoder == "ingested" else None
    vae, params, model, _ = _pair(kw, spec=spec)
    x = _x((4, 16, 16, 1), seed=10)
    key = jax.random.PRNGKey(11)
    ref = vae.apply(params, jnp.asarray(x), rng=key)
    with torch.no_grad():
        got = model(torch.from_numpy(x), eps=torch.from_numpy(_eps(key, (4, 8))))
        det = model(torch.from_numpy(x))
    for k in ("recon", "z", "mu", "logvar"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **F32)
    assert torch.equal(det["z"], det["mu"]) and not torch.equal(got["z"], got["mu"])


def _grad_tree(model, tcfg, spec=None):
    grads = {k: p.grad for k, p in model.named_parameters()}
    return t_convert.params_for_jax(grads, t_convert.vae_slots(tcfg, spec))


@pytest.mark.parametrize("beta", [0.0, 0.3])
@pytest.mark.parametrize("downsample", ["stride", "avgpool"])
def test_loss_and_every_gradient(downsample, beta):
    kw = dict(SMALL, downsample=downsample)
    vae, params, model, tcfg = _pair(kw, seed=12)
    x = _x((4, 16, 16, 1), seed=13)
    key = jax.random.PRNGKey(14)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: j_train.vae_loss(vae, p, jnp.asarray(x), key, beta), has_aux=True)(params)
    loss, m = t_train.vae_loss(model, torch.from_numpy(x), torch.from_numpy(_eps(key, (4, 8))), beta)
    loss.backward()
    for k in ("loss", "recon", "kl"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    got = _grad_tree(model, tcfg)
    ref = _np(jgrads)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    for g, r in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * float(np.abs(r).max()))


BF16_GRAD, BF16_GRAD_BIAS = 6e-2, 0.2  # of each tensor's largest gradient (module docstring)


@pytest.mark.parametrize("beta", [0.0, 0.3])
@pytest.mark.parametrize("downsample", ["stride", "avgpool"])
def test_bf16_loss_and_every_gradient(downsample, beta):
    """The bf16 trunk's loss and gradients against JAX's bf16
    ``value_and_grad``, leaf by leaf."""
    kw = dict(SMALL, downsample=downsample)
    jcfg, tcfg = j_vae.VAEConfig(**kw, dtype=jnp.bfloat16), t_vae.VAEConfig(**kw, dtype="bfloat16")
    vae, params = j_vae.init_vae(jcfg, seed=12)
    model = t_vae.ConvVAE(tcfg)
    model.load_state_dict(t_convert.state_from_jax(_np(params), t_convert.vae_slots(tcfg)))
    x = _x((4, 16, 16, 1), seed=13)
    key = jax.random.PRNGKey(14)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: j_train.vae_loss(vae, p, jnp.asarray(x), key, beta), has_aux=True)(params)
    loss, m = t_train.vae_loss(model, torch.from_numpy(x), torch.from_numpy(_eps(key, (4, 8))), beta)
    loss.backward()
    for k in ("loss", "recon", "kl"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-2)
    got = _grad_tree(model, tcfg)
    ref = jax.tree_util.tree_leaves_with_path(_np(jgrads))
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(_np(jgrads))
    for g, (path, r) in zip(jax.tree_util.tree_leaves(got), ref):
        name = jax.tree_util.keystr(path)
        assert g.shape == r.shape and g.dtype == np.float32, name
        tol = BF16_GRAD_BIAS if name.endswith("['bias']") else BF16_GRAD
        err = float(np.abs(g - r).max() / np.abs(r).max())
        assert err <= tol, (name, err)


@pytest.mark.parametrize("warmup,total", [(0, 10), (1, 10), (5, 20), (7, 3), (4, 5)])
def test_lr_schedule_matches_optax(warmup, total):
    tc = t_train.TrainConfig(learning_rate=1e-3, warmup_steps=warmup, total_steps=total)
    ours = t_train.make_schedule(tc)
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, max(total, warmup + 1))
    for step in range(total + warmup + 4):
        assert abs(ours(step) - float(ref(step))) <= 1e-9, step


def test_kl_beta_matches_the_jax_step():
    """β_t as JAX's ``make_train_step`` applies it, read back from its
    metrics as (loss - recon) / kl, over the delay, the ramp and after."""
    tc = j_train.TrainConfig(warmup_steps=1, total_steps=10, beta=0.4, kl_delay_steps=2, kl_warmup_steps=3)
    vae, state = j_train.create_train_state(j_vae.VAEConfig(**SMALL), tc)
    step = jax.jit(j_train.make_train_step(vae, tc.beta, tc.kl_warmup_steps, tc.kl_delay_steps))
    batch = jnp.asarray(_x((2, 16, 16, 1), seed=15))
    for k in range(7):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        jbeta = (float(m["loss"]) - float(m["recon"])) / float(m["kl"])
        np.testing.assert_allclose(t_train.kl_beta(0.4, k, 3, 2), jbeta, rtol=1e-5, atol=1e-7)
    assert t_train.kl_beta(0.4, 5, 0, 0) == 0.4


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("downsample", ["stride", "avgpool"])
def test_three_adamw_steps_match_jax(downsample, bf16):
    kw = dict(SMALL, downsample=downsample)
    jtc = j_train.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, beta=0.1, kl_delay_steps=1,
                              kl_warmup_steps=2)
    ttc = t_train.TrainConfig(**dataclasses.asdict(jtc))
    jcfg = j_vae.VAEConfig(**kw, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tcfg = t_vae.VAEConfig(**kw, dtype="bfloat16" if bf16 else "float32")
    vae, state = j_train.create_train_state(jcfg, jtc)
    _, tstate = t_train.create_train_state(
        tcfg, ttc, init_params=t_convert.state_from_jax(_np(state.params), t_convert.vae_slots(tcfg)), device="cpu")
    jstep = jax.jit(j_train.make_train_step(vae, jtc.beta, jtc.kl_warmup_steps, jtc.kl_delay_steps))
    tstep = t_train.make_train_step(ttc.beta, ttc.kl_warmup_steps, ttc.kl_delay_steps)
    key = jax.random.PRNGKey(3)
    for k in range(3):
        batch = _x((4, 16, 16, 1), seed=20 + k)
        state, jm = jstep(state, jnp.asarray(batch), key)
        tstate, tm = tstep(tstate, torch.from_numpy(batch), torch.from_numpy(_eps(jax.random.fold_in(key, k), (4, 8))))
        for name in ("loss", "recon", "kl"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-2 if bf16 else 1e-5)
    assert tstate.step == int(state.step) == 3
    got = jax.tree_util.tree_leaves(t_convert.params_for_jax(tstate.model.state_dict(), t_convert.vae_slots(tcfg)))
    ref = jax.tree_util.tree_leaves(_np(state.params))
    d = np.concatenate([np.abs(g - r).ravel() for g, r in zip(got, ref)])
    scale = np.concatenate([np.abs(r).ravel() for r in ref])
    if bf16:  # the rule of the module docstring: steps differ in units of lr
        assert np.mean(d > jtc.learning_rate / 4) <= 0.01
    else:
        assert np.mean(d > 1e-5 + 1e-4 * scale) <= 0.01


@pytest.mark.parametrize("what", ["vae", "decoder"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_artifacts_cross_packages(tmp_path, writer, what):
    d = tmp_path / "art"
    if what == "vae":
        kw = dict(ODD, downsample="avgpool")
        jcfg, tcfg = j_vae.VAEConfig(**kw), t_vae.VAEConfig(**kw)
        _, jparams = j_vae.init_vae(jcfg, seed=5)
        slots = t_convert.vae_slots(tcfg)
    else:
        jspec, tspec = j_vae.DecoderSpec(**_spec("mixed", "group")), t_vae.DecoderSpec(**_spec("mixed", "group"))
        _, jparams = j_vae.init_ingested_decoder(jspec, seed=5)
        slots = t_convert.ingested_decoder_slots(tspec)
    jparams = jax.tree_util.tree_map(lambda a: a + 0.1 * _x(a.shape, seed=a.size + 1), jparams)
    state = t_convert.state_from_jax(_np(jparams), slots)
    if writer == "jax":
        (j_ckpt.save_vae(d, jcfg, jparams) if what == "vae" else j_ckpt.save_decoder(d, jspec, jparams))
        got, meta = t_ckpt.load_vae(d) if what == "vae" else t_ckpt.load_decoder(d)
        assert meta == (tcfg if what == "vae" else tspec)
        assert got.keys() == state.keys() and all(torch.equal(got[k], state[k]) for k in got)
    else:
        (t_ckpt.save_vae(d, tcfg, state) if what == "vae" else t_ckpt.save_decoder(d, tspec, state))
        _, back, meta = j_ckpt.load_vae(d) if what == "vae" else j_ckpt.load_decoder(d)
        assert meta == (jcfg if what == "vae" else jspec)
        for a, b in zip(jax.tree_util.tree_leaves(_np(back)), jax.tree_util.tree_leaves(_np(jparams))):
            np.testing.assert_array_equal(a, b)


def test_encoder_params_from_vae_serve():
    _, params, model, tcfg = _pair(SMALL)
    enc = t_vae.ConvVAEEncoder(tcfg)
    enc.load_state_dict(t_vae.encoder_params_from_vae(model.state_dict()))
    x = torch.from_numpy(_x((2, 16, 16, 1), seed=16))
    with torch.no_grad():
        assert torch.equal(enc(x)["mu"], model.encode(x)["mu"])
    jenc = j_vae.encoder_params_from_vae(params)
    want = j_vae.ConvVAEEncoder(j_vae.VAEConfig(**SMALL)).apply(jenc, jnp.asarray(x.numpy()))["mu"]
    np.testing.assert_allclose(enc(x)["mu"].detach().numpy(), np.asarray(want), **F32)


def test_save_restore_continue_matches_uninterrupted(tmp_path):
    """The port's save -> restore -> continue equals an uninterrupted run,
    bitwise, with the noise each step draws from (seed, step)."""
    cfg = t_vae.VAEConfig(**SMALL)
    tc = t_train.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, beta=0.1, kl_delay_steps=1,
                             kl_warmup_steps=2, seed=4)
    batches = [torch.from_numpy(_x((4, 16, 16, 1), seed=30 + k)) for k in range(4)]
    step = t_train.make_train_step(tc.beta, tc.kl_warmup_steps, tc.kl_delay_steps, seed=tc.seed)

    _, a = t_train.create_train_state(cfg, tc, device="cpu")
    for b in batches[:2]:
        a, _ = step(a, b)
    t_ckpt.save_train_state(tmp_path / "ckpt", a, step=1)  # an older step: the latest wins
    t_ckpt.save_train_state(tmp_path / "ckpt", a)
    assert t_ckpt.latest_step(tmp_path / "ckpt") == 2
    _, template = t_train.create_train_state(cfg, tc, device="cpu")
    restored = t_ckpt.restore_train_state(tmp_path / "ckpt", template)
    assert restored.step == 2
    for b in batches[2:]:
        restored, mr = step(restored, b)

    _, u = t_train.create_train_state(cfg, tc, device="cpu")
    for b in batches:
        u, mu = step(u, b)
    assert torch.equal(mr["loss"], mu["loss"])
    su, sr = u.model.state_dict(), restored.model.state_dict()
    assert all(torch.equal(su[k], sr[k]) for k in su)

    # train_loop accepts the restored state and counts on from it
    _, again = t_train.create_train_state(cfg, tc, device="cpu")
    again = t_ckpt.restore_train_state(tmp_path / "ckpt", again)
    _, s3, m3 = t_train.train_loop(cfg, tc, iter([b.numpy() for b in batches[2:]]), num_steps=2, log_every=0,
                                   initial_state=again)
    assert s3.step == 4 and m3["loss"] == float(mu["loss"])
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore_train_state(tmp_path / "none", template)


def _bad(**kw):
    good = dict(_spec("convt", "group", latent=8), bottleneck_hw=(4, 4), dense_widths=(20, 12 * 16))
    return t_vae.DecoderSpec(**{**good, **kw})


@pytest.mark.parametrize("spec,match", [
    (_bad(bottleneck_hw=(4, 3), dense_widths=(20, 12 * 12)), "reconstructs"),
    (_bad(latent_dim=6), "latent_dim"),
    (_bad(stack=(("convt", 8), ("conv", 8), ("convt", 4), ("conv", 2))), "channels"),
], ids=["out_hw", "latent_dim", "channels"])
def test_convvae_rejects_mismatched_decoder_spec(spec, match):
    with pytest.raises(ValueError, match=match):
        t_vae.ConvVAE(t_vae.VAEConfig(**SMALL), spec)
    jspec = j_vae.DecoderSpec(**dataclasses.asdict(spec))
    with pytest.raises(ValueError, match=match):  # the JAX package refuses the same spec
        j_vae.init_vae(j_vae.VAEConfig(**SMALL), decoder_spec=jspec)


def test_init_params_structure_is_checked():
    cfg = t_vae.VAEConfig(**SMALL)
    tc = t_train.TrainConfig()
    _, params = t_vae.init_vae(t_vae.VAEConfig(**dict(SMALL, latent_dim=6)))
    with pytest.raises(ValueError, match="structure"):
        t_train.create_train_state(cfg, tc, init_params=params, device="cpu")
    _, state = t_train.create_train_state(cfg, tc, init_params=t_vae.init_vae(cfg, seed=9)[1], device="cpu")
    assert all(g["weight_decay"] == tc.weight_decay for g in state.optimizer.param_groups)
    assert len(state.optimizer.param_groups) == 1  # every leaf decayed, as optax's adamw
