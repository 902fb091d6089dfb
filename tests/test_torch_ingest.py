"""The port's torch-checkpoint ingest (``anuraxla_torch.models.ingest``,
``models.hydra_ingest``, the ``ingest-encoder`` / ``ingest-decoder`` CLIs)
held against the JAX package's on the CPU.

The checkpoints come from the JAX suite's own generator
(``tests/test_ingest_fuzz.py``, imported, not copied): eight encoder seeds
that span both downsample families, GroupNorm / BatchNorm (affine or not) /
no norm, one and two heads, and bare / wrapped / pickled-module saves, and
four decoder seeds over both stack families, GroupNorm / BatchNorm / none,
and pickled / bare saves. Each is ingested by both packages: the configs
and specs must be equal, the port's state_dict bitwise the reference's tree
(through ``models.convert``), and the port's modules must reproduce the torch
twin at the fuzz suite's tolerances.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch
import yaml

from anuraxla.models import hydra_ingest as jh
from anuraxla.models import ingest as ji
from anuraxla.models.checkpoint import load_decoder as j_load_decoder
from anuraxla.models.checkpoint import load_encoder as j_load_encoder
from anuraxla_torch.cli import ingest_decoder as t_ingest_decoder
from anuraxla_torch.cli import ingest_encoder as t_ingest_encoder
from anuraxla_torch.models import hydra_ingest as th
from anuraxla_torch.models import ingest as ti
from anuraxla_torch.models.convert import encoder_params_for_jax, ingested_decoder_slots, params_for_jax
from anuraxla_torch.models.vae import ConvVAEEncoder, IngestedDecoder, VAEConfig
from test_ingest_fuzz import (
    ENCODER_MUTATIONS,
    _FuzzDecoder,
    _materialize_encoder,
    _rand_decoder_spec,
    _rand_encoder_spec,
    _sequential_yaml_tree,
    _valid_encoder_sd,
)

# (seed: family, norm, heads, save) — see the module docstring
ENCODER_SEEDS = [1, 2, 3, 6, 8, 9, 12, 27]
DECODER_SEEDS = [0, 5, 6, 19]


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _assert_trees_equal(a, b, path=""):
    a, b = a.get("params", a), b.get("params", b)
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y), f"{path}/{k}"


def _cfg_fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("dtype")  # the JAX package keeps a jnp dtype, the port a name
    return {k: (tuple(v) if isinstance(v, (list, tuple)) else v) for k, v in d.items()}


def _ingest_both(fn_t, fn_j, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # benign ambiguity warnings
        return fn_t(*args, **kw), fn_j(*args, **kw)


@pytest.mark.parametrize("seed", ENCODER_SEEDS)
def test_encoder_ingest_matches_jax(seed, tmp_path):
    spec = _rand_encoder_spec(seed)
    mod, pt = _materialize_encoder(spec, tmp_path)
    kw = dict(n_mels=spec["n_mels"], groups=spec["groups"],
              downsample=None if spec["save"] == "module" else spec["family"])
    (cfg, state, meta), (jcfg, jparams, jmeta) = _ingest_both(
        th.ingest_foreign_checkpoint, jh.ingest_foreign_checkpoint, pt, **kw)
    assert isinstance(cfg, VAEConfig) and _cfg_fields(cfg) == _cfg_fields(jcfg)
    assert meta == jmeta
    assert cfg.downsample == spec["family"] and tuple(cfg.widths) == spec["widths"]
    _assert_trees_equal(encoder_params_for_jax(state, cfg), _np_tree(jparams))

    x = np.random.default_rng(seed + 2).standard_normal((2, 1, cfg.input_hw[0], spec["n_mels"])).astype(np.float32)
    with torch.no_grad():
        ref = mod(torch.from_numpy(x))
    enc = ConvVAEEncoder(cfg)
    enc.load_state_dict(state)
    with torch.no_grad():
        out = enc(torch.from_numpy(x.transpose(0, 2, 3, 1).copy()))
    if spec["heads"] == 2:
        np.testing.assert_allclose(out["mu"].numpy(), ref["mu"].numpy(), rtol=5e-4, atol=3e-5)
        np.testing.assert_allclose(out["logvar"].numpy(), ref["logvar"].numpy(), rtol=5e-4, atol=3e-5)
    else:
        np.testing.assert_allclose(out["mu"].numpy(), ref.numpy(), rtol=5e-4, atol=3e-5)
        assert torch.all(out["logvar"] == 0.0)


@pytest.mark.parametrize("seed", DECODER_SEEDS)
def test_decoder_ingest_matches_jax(seed, tmp_path):
    spec = _rand_decoder_spec(seed)
    torch.manual_seed(20_000 + seed)
    mod = _FuzzDecoder(spec)
    if spec["norm"] == "bn" or spec["tail_bn"]:
        with torch.no_grad():
            for _ in range(2):
                mod(torch.from_numpy(np.random.default_rng(seed).standard_normal(
                    (3, spec["latent"])).astype(np.float32)))
    mod = mod.eval()
    pt = tmp_path / f"dec_{seed}.pt"
    torch.save(mod.state_dict() if seed % 2 else mod, pt)
    (dspec, state, meta), (jspec, jparams, jmeta) = _ingest_both(
        th.ingest_foreign_decoder, jh.ingest_foreign_decoder, pt, n_mels=spec["n_mels"], groups=spec["groups"])
    assert dataclasses.asdict(dspec) == dataclasses.asdict(jspec) and meta == jmeta
    _assert_trees_equal(params_for_jax(state, ingested_decoder_slots(dspec)), _np_tree(jparams))

    z = np.random.default_rng(seed + 5).standard_normal((3, spec["latent"])).astype(np.float32)
    with torch.no_grad():
        ref = mod(torch.from_numpy(z)).numpy()
    dec = IngestedDecoder(dspec)
    dec.load_state_dict(state)
    with torch.no_grad():
        got = dec(torch.from_numpy(z)).numpy()
    assert got.shape == (3, *dspec.out_hw, spec["out_ch"])
    np.testing.assert_allclose(got.transpose(0, 3, 1, 2), ref, rtol=5e-4, atol=5e-5)


def _error(fn, *args, **kw) -> str:
    with pytest.raises(ValueError) as e, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fn(*args, **kw)
    return f"{type(e.value).__name__}: {e.value}"


@pytest.mark.parametrize("idx", range(len(ENCODER_MUTATIONS)))
def test_unsupported_layers_named_as_jax(idx):
    mutate, needle = ENCODER_MUTATIONS[idx]
    sd = _valid_encoder_sd()
    mutate(sd)
    got = _error(th.infer_vae_config_from_state_dict, sd, n_mels=8)
    assert got == _error(jh.infer_vae_config_from_state_dict, sd, n_mels=8)
    assert got.startswith("UnsupportedLayerError: ") and needle.lower() in got.lower()


def test_decoder_and_probe_errors_named_as_jax(tmp_path):
    r = np.random.default_rng(1)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    tail_gn = {"fc.weight": f(16, 6), "fc.bias": f(16), "ct.weight": f(4, 4, 4, 4), "ct.bias": f(4),
               "out.weight": f(1, 4, 3, 3), "out.bias": f(1), "tail_gn.weight": f(1), "tail_gn.bias": f(1)}
    unsolvable = {"fc.weight": f(24, 6), "fc.bias": f(24), "ct.weight": f(4, 4, 4, 4), "ct.bias": f(4),
                  "out.weight": f(1, 4, 3, 3), "out.bias": f(1)}
    for sd, n_mels, needle in ((tail_gn, 4, "GroupNorm"), (unsolvable, 16, "not divisible")):
        got = _error(th.infer_decoder_spec_from_state_dict, sd, n_mels=n_mels, groups=1)
        assert got == _error(jh.infer_decoder_spec_from_state_dict, sd, n_mels=n_mels, groups=1) and needle in got
    # a pickled module that runs but lies outside the vocabulary: the error
    # carries its probed target_frames
    mod = torch.nn.Sequential(torch.nn.Conv2d(1, 4, 5, padding=2), torch.nn.Flatten(), torch.nn.Linear(4 * 16 * 8, 3))
    pt = tmp_path / "odd.pt"
    torch.save(mod, pt)
    got = _error(th.ingest_foreign_checkpoint, pt, n_mels=8)
    assert got == _error(jh.ingest_foreign_checkpoint, pt, n_mels=8) and "target_frames=16" in got
    assert th.probe_frames_with_hook(mod, n_mels=8) == jh.probe_frames_with_hook(mod, n_mels=8) == 16


def test_twin_and_name_mapping_match_jax():
    """``torch_twin_encoder`` / ``torch_state_dict_to_flax``: the twin's
    state_dict maps to the reference's tree bitwise, and the port's encoder on
    it reproduces the twin (XLA SAME pads on the stride-2 convs)."""
    cfg = VAEConfig(widths=(8, 16), dense_width=24, latent_dim=6, input_hw=(32, 16), groups=4)
    torch.manual_seed(5)
    twin = ti.torch_twin_encoder(cfg).eval()
    sd = twin.state_dict()
    tree = ti.torch_state_dict_to_flax(sd, cfg)
    _assert_trees_equal(tree, ji.torch_state_dict_to_flax(sd, cfg))
    assert ti.split_model_and_state(twin).keys() == ji.split_model_and_state({"state_dict": sd}).keys()
    x = np.random.default_rng(3).standard_normal((2, 1, 32, 16)).astype(np.float32)
    enc = ConvVAEEncoder(cfg)
    from anuraxla_torch.models.convert import encoder_state_from_jax

    enc.load_state_dict(encoder_state_from_jax(tree, cfg))
    with torch.no_grad():
        ref = twin(torch.from_numpy(x))["mu"].numpy()
        got = enc(torch.from_numpy(x.transpose(0, 2, 3, 1).copy()))["mu"].numpy()
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=3e-5)


def test_yaml_tree_instantiates_as_jax(tmp_path):
    """Hydra YAML handling: interpolations left as they are, private module
    paths resolved against torch.nn, the factory convention, meta-keys
    dropped — the same modules as the reference builds."""
    tree = {"encoder": {"_target_": "soundscape_vae.layers.Sequential", "_recursive_": True, "_args_": [
        {"_target_": "torch.nn.Conv2d", "_args_": [1, 4, 3], "padding": 1},
        {"_target_": "soundscape_vae.GroupNorm", "_args_": [2, 4], "_convert_": "all"},
        {"_target_": "torch.nn.SiLU"}]}, "train": {"lr": "${optim.lr}"}}
    yml = tmp_path / "m.yaml"
    yml.write_text(yaml.safe_dump(tree))
    cfg = th.load_yaml_cfg(yml)
    assert cfg == jh.load_yaml_cfg(yml) and cfg["train"]["lr"] == "${optim.lr}"
    mt = th.build_nn_module(th.instantiate_target_tree(th.pick_encoder_cfg(cfg)))
    mj = jh.build_nn_module(jh.instantiate_target_tree(jh.pick_encoder_cfg(cfg)))
    assert repr(mt) == repr(mj) and isinstance(mt[1], torch.nn.GroupNorm)
    assert th._find_int_key(tree, ("num_groups", "groups")) is None
    for fn in (th.pick_encoder_cfg, jh.pick_encoder_cfg):
        with pytest.raises(ValueError, match="no 'encoder:' block"):
            fn({"decoder": {}})


@pytest.mark.parametrize("seed", [0, 1])
def test_ingest_encoder_cli_verify_roundtrip(seed, tmp_path, capsys):
    """``ingest-encoder --verify --device cpu`` on a random YAML _target_ tree
    (the fuzz suite's): the artifact loads in the JAX package to the tree
    the JAX package's own ingest builds, bitwise."""
    r = np.random.default_rng(seed + 77)
    depth = int(r.integers(1, 3))
    widths = tuple(int(w) for w in r.choice([4, 8], size=depth))
    groups = int(r.choice([1, 2]))
    dense, latent = int(r.integers(8, 24)), int(r.integers(3, 9))
    n_mels, frames = 16, int(r.integers(2**depth, 32))
    bt, bm = th.bottleneck_for(frames, n_mels, depth)
    tree = _sequential_yaml_tree(widths, groups, dense, latent, bt, bm)
    yml = tmp_path / "model.yaml"
    yml.write_text(yaml.safe_dump(tree))
    torch.manual_seed(seed)
    mod = th.build_nn_module(th.instantiate_target_tree(tree["encoder"])).eval()
    pt = tmp_path / "model.pt"
    torch.save({"state_dict": mod.state_dict()}, pt)
    out_dir = tmp_path / "artifact"
    t_ingest_encoder.main(["--pt", str(pt), "--yaml", str(yml), "--out", str(out_dir), "--n-mels", str(n_mels),
                           "--groups", str(groups), "--verify", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "✅ verified vs torch module" in out and "💾 artifact" in out
    _, params, jcfg = j_load_encoder(out_dir)
    want_cfg, want, _ = jh.ingest_foreign_checkpoint(pt, yml, n_mels=n_mels, groups=groups)
    assert _cfg_fields(jcfg) == _cfg_fields(want_cfg)
    _assert_trees_equal(_np_tree(params), _np_tree(want))


def test_ingest_decoder_cli_verify_roundtrip(tmp_path, capsys):
    spec = _rand_decoder_spec(6)
    torch.manual_seed(20_006)
    mod = _FuzzDecoder(spec).eval()
    pt = tmp_path / "dec.pt"
    torch.save(mod, pt)
    out_dir = tmp_path / "dec_artifact"
    t_ingest_decoder.main(["--pt", str(pt), "--out", str(out_dir), "--n-mels", str(spec["n_mels"]),
                           "--groups", str(spec["groups"]), "--verify", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "✅ verified vs torch module" in out
    _, jparams, jspec = j_load_decoder(out_dir)
    want_spec, want, _ = jh.ingest_foreign_decoder(pt, n_mels=spec["n_mels"], groups=spec["groups"])
    assert dataclasses.asdict(jspec) == dataclasses.asdict(want_spec)
    _assert_trees_equal(_np_tree(jparams), _np_tree(want))
    # a bare state_dict has no forward to verify against
    torch.save(mod.state_dict(), pt)
    with pytest.raises(SystemExit, match="runnable pickled module"):
        t_ingest_decoder.main(["--pt", str(pt), "--out", str(out_dir), "--n-mels", str(spec["n_mels"]),
                               "--verify", "--device", "cpu"])


def test_ingest_clis_need_a_card_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    spec = _rand_decoder_spec(0)
    pt = tmp_path / "dec.pt"
    torch.save(_FuzzDecoder(spec).eval(), pt)
    with pytest.raises(RuntimeError, match="device='cuda'"):
        t_ingest_decoder.main(["--pt", str(pt), "--out", str(tmp_path / "o"), "--n-mels", str(spec["n_mels"]),
                               "--verify"])
    with pytest.raises(RuntimeError, match="device='cuda'"):
        t_ingest_encoder.main(["--pt", str(pt), "--out", str(tmp_path / "o"), "--verify"])
