"""The port's encoder (``anuraxla_torch.models``) held against the flax
``ConvVAEEncoder`` on the same params: flax params carried across with
``encoder_state_from_jax``, mu and logvar within rtol 5e-4 / atol 2e-5
(the tolerance of test_models.py's torch twin). The odd input size catches
the asymmetric XLA SAME padding on stride-2 convs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anuraxla.models.quant import _same_pads
from anuraxla.models.vae import VAEConfig as JVAE
from anuraxla.models.vae import bottleneck_for as j_bottleneck_for
from anuraxla.models.vae import init_encoder
from anuraxla_torch.models.convert import encoder_state_from_jax
from anuraxla_torch.models.vae import ConvVAEEncoder, VAEConfig, bottleneck_for, init_encoder_params, same_pads

SMALL = dict(latent_dim=16, widths=(8, 16), dense_width=32, groups=4, input_hw=(48, 32))


def _pair(**kw):
    base = dict(SMALL, **kw)
    jcfg = JVAE(**base)
    enc, params = init_encoder(jcfg, seed=3)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    tcfg = VAEConfig(**base)
    model = ConvVAEEncoder(tcfg)
    model.load_state_dict(encoder_state_from_jax(params_np, tcfg))
    return enc, params, model.eval(), tcfg


@pytest.mark.parametrize("norm", ["group", "none"])
@pytest.mark.parametrize("conv_padding", ["SAME", "TORCH"])
@pytest.mark.parametrize("input_hw", [(48, 32), (45, 30)])
def test_encoder_matches_flax(norm, conv_padding, input_hw):
    enc, params, model, _ = _pair(norm=norm, conv_padding=conv_padding, input_hw=input_hw)
    x = np.random.default_rng(7).standard_normal((3, *input_hw, 1)).astype(np.float32)
    ref = enc.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in ("mu", "logvar", "z"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=5e-4, atol=2e-5)


def test_gn_eps_read_from_config():
    enc, params, model, _ = _pair(gn_eps=1e-5)
    assert all(b.gn1.eps == 1e-5 and b.gn2.eps == 1e-5 for b in model.blocks)
    x = np.random.default_rng(8).standard_normal((2, 48, 32, 1)).astype(np.float32) * 1e-3
    with torch.no_grad():
        got = model(torch.from_numpy(x))["mu"].numpy()
    np.testing.assert_allclose(got, np.asarray(enc.apply(params, jnp.asarray(x))["mu"]), rtol=5e-4, atol=2e-5)


def test_bf16_trunk_close_to_f32():
    _, _, model, tcfg = _pair()
    bf = ConvVAEEncoder(dataclasses.replace(tcfg, dtype="bfloat16"))
    bf.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((4, 48, 32, 1)).astype(np.float32))
    with torch.no_grad():
        a, b = model(x)["mu"], bf(x)["mu"]
    assert b.dtype == torch.float32  # the heads stay f32
    cos = torch.nn.functional.cosine_similarity(a, b, dim=1)
    assert float(cos.min()) > 0.99


def test_shape_helpers_match_reference():
    for size in range(1, 40):
        assert same_pads(size, 2) == _same_pads(size, 2)
        assert same_pads(size, 1) == _same_pads(size, 1)
    for hw in ((192, 64), (45, 30), (7, 3)):
        for mode in ("stride", "avgpool"):
            assert bottleneck_for(*hw, 4, mode) == j_bottleneck_for(*hw, 4, mode)
    assert VAEConfig().bottleneck_hw == JVAE().bottleneck_hw == (12, 4)


def test_seeded_init_is_deterministic_and_loads():
    cfg = VAEConfig()
    a = init_encoder_params(cfg, torch.Generator().manual_seed(5))
    b = init_encoder_params(cfg, torch.Generator().manual_seed(5))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    model = ConvVAEEncoder(cfg)
    model.load_state_dict(a)
    n = sum(p.numel() for p in model.parameters())
    _, jparams = init_encoder(JVAE(), seed=0)
    assert n == sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(jparams))
    # the avgpool family builds with the JAX package's parameter count
    pooled = ConvVAEEncoder(VAEConfig(downsample="avgpool"))
    pooled.load_state_dict(init_encoder_params(VAEConfig(downsample="avgpool"), torch.Generator().manual_seed(5)))
    _, jpooled = init_encoder(JVAE(downsample="avgpool"), seed=0)
    assert sum(p.numel() for p in pooled.parameters()) == sum(
        int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(jpooled))
    with pytest.raises(ValueError, match="downsample"):
        ConvVAEEncoder(VAEConfig(downsample="maxpool"))
