"""The port's parallel slice (``anuraxla_torch.parallel``) held against the
JAX package's ``anuraxla.parallel`` on the CPU: the same numpy inputs, made
from a seed, through JAX's sharded function on the 8-virtual-device mesh of
``tests/conftest.py`` and the port's on 8 CPU shards
(``parallel.mesh.set_default_devices``), and the callers that branch into it
(``EncoderSession(data_parallel=True)``, the tree fits and the folder
benchmark, the device sweep's pad-and-mask, ``train-vae``), plus the CLI
flags ``--data-parallel`` and ``--allow-init-encoder`` under both packages'
parsers.

Tolerances are the JAX suite's (``tests/test_parallel.py``): encode rtol
2e-4 / atol 2e-5, radial fit 1e-5 / 1e-6, MAP fit 2e-4 / 2e-5 (τ 1e-4 /
1e-5), ``sharded_quantile`` 1 ulp of ``masked_quantile``, the train step's
loss 1e-4 and parameters 2e-3 / 2e-4; decisions identical."""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anuraxla.models import train as j_train
from anuraxla.models import vae as j_vae
from anuraxla.parallel import encode as j_penc
from anuraxla.parallel import fit as j_pfit
from anuraxla.parallel import mesh as j_mesh
from anuraxla_torch.constants import MelConfig
from anuraxla_torch.detect import gaussian_map as t_map
from anuraxla_torch.detect import radial as t_radial
from anuraxla_torch.models import convert as t_convert
from anuraxla_torch.models import train as t_train
from anuraxla_torch.models import vae as t_vae
from anuraxla_torch.ops import linalg as t_linalg
from anuraxla_torch.ops import quantiles as t_q
from anuraxla_torch.parallel import encode as t_penc
from anuraxla_torch.parallel import fit as t_pfit
from anuraxla_torch.parallel import mesh as t_mesh
from anuraxla_torch.parallel import multihost as t_multihost
from anuraxla_torch.parallel import train_sharded as t_ts

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices (conftest sets them)")

TOY_MEL = dict(duration=0.25, target_frames=32, n_mels=32, sr=16000, fmax=7000)
TOY_ENC = dict(latent_dim=16, widths=(8, 16), dense_width=32, groups=4, input_hw=(32, 32))


@pytest.fixture
def cpu8():
    """8 CPU shards as the default devices of a cpu mesh, restored after."""
    t_mesh.set_default_devices(["cpu"] * 8)
    yield t_mesh.make_mesh(device="cpu")
    t_mesh.set_default_devices(None)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rand_latents(rng, K=4, D=12, ns=(37, 24, 51, 10)):
    Nmax = max(ns)
    Z = np.zeros((K, Nmax, D), np.float32)
    mask = np.zeros((K, Nmax), bool)
    for k, n in enumerate(ns):
        Z[k, :n] = rng.standard_normal((n, D)).astype(np.float32) + 3.0 * k
        mask[k, :n] = True
    return Z, mask


def test_mesh_shapes_and_pad_to_multiple(cpu8):
    m = t_mesh.make_mesh(device="cpu")
    jm = j_mesh.make_mesh()
    assert m.shape == dict(jm.shape) == {"data": 8, "model": 1}
    m2, jm2 = t_mesh.make_mesh(model_axis=2, device="cpu"), j_mesh.make_mesh(model_axis=2)
    assert m2.shape == dict(jm2.shape) == {"data": 4, "model": 2}
    assert m2.data_devices == [torch.device("cpu")] * 4 and m2.local_slices(8) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="not divisible by model_axis"):
        t_mesh.make_mesh(n_devices=6, model_axis=4, device="cpu")
    with pytest.raises(ValueError, match="only 8 available"):
        t_mesh.make_mesh(n_devices=9, device="cpu")
    # the default without the setter: one CPU shard for a cpu mesh
    t_mesh.set_default_devices(None)
    assert t_mesh.make_mesh(device="cpu").shape == {"data": 1, "model": 1}
    for shape, mult in (((10, 3), 8), ((16, 3), 8), ((3, 5), 4)):
        x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        for axis in (0, 1):
            got, n = t_mesh.pad_to_multiple(x, mult, axis=axis)
            want, nj = j_mesh.pad_to_multiple(x, mult, axis=axis)
            np.testing.assert_array_equal(got, want)
            assert n == nj
    with pytest.raises(ValueError, match="must divide by the data axis"):
        t_mesh.batch_sharded(lambda i, x: x, m, batch_size=12)


def test_psum_pmax_all_gather_in_shard_order(cpu8):
    parts = [torch.full((2, 3), float(i)) for i in range(8)]
    assert torch.equal(t_mesh.psum(parts, cpu8), torch.full((2, 3), 28.0))
    assert torch.equal(t_mesh.pmax(parts, cpu8), torch.full((2, 3), 7.0))
    g = t_mesh.all_gather(parts, cpu8, dim=1)
    assert g.shape == (2, 24) and torch.equal(g[0], torch.arange(8.0).repeat_interleave(3))
    run = t_mesh.batch_sharded(lambda i, x: torch.as_tensor(x) * 0 + i, cpu8, batch_size=16)
    assert run(np.zeros((16, 2), np.float32))[:, 0].tolist() == [i // 2 for i in range(16)]


def test_sharded_encode_matches_jax(rng, cpu8):
    """Port and JAX sharded encodes on the same params and audio (the matmul
    frontend on both sides), and the port's against its own unsharded forward."""
    from anuraxla.constants import MelConfig as JMel
    from anuraxla_torch.ops.frontend import log_mel_batch, mel_to_encoder_input

    mel, jcfg, tcfg = MelConfig(**TOY_MEL), j_vae.VAEConfig(**TOY_ENC), t_vae.VAEConfig(**TOY_ENC)
    enc, params = j_vae.init_encoder(jcfg, seed=0)
    model = t_vae.ConvVAEEncoder(tcfg)
    model.load_state_dict(t_convert.encoder_state_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    model.eval()
    audio = (rng.standard_normal((16, mel.num_samples)) * 0.1).astype(np.float32)

    z_j = np.asarray(j_penc.make_sharded_encode(j_mesh.make_mesh(), enc.apply, JMel(**TOY_MEL))(
        params, jnp.asarray(audio)))
    z_t = _np(t_penc.make_sharded_encode(cpu8, model, mel, backend="matmul")(audio))
    np.testing.assert_allclose(z_t, z_j, rtol=2e-4, atol=2e-5)
    with torch.no_grad():
        ref = model(mel_to_encoder_input(log_mel_batch(_t(audio), mel, backend="matmul")))["mu"]
    np.testing.assert_allclose(z_t, _np(ref), rtol=2e-4, atol=2e-5)


def test_sharded_pooled_cov_matches_jax_and_masked_cov(rng, cpu8):
    N, D = 64, 12
    Zc = rng.standard_normal((N, D)).astype(np.float32)
    Zc -= Zc.mean(0)
    mask = np.ones(N, bool)
    mask[50:] = False
    cov, n = t_penc.sharded_pooled_cov(cpu8)(Zc, mask)
    jcov, jn = j_penc.sharded_pooled_cov(j_mesh.make_mesh())(jnp.asarray(Zc), jnp.asarray(mask))
    assert int(n) == int(jn) == 50
    np.testing.assert_allclose(_np(cov), np.asarray(jcov), rtol=1e-4, atol=1e-5)
    ref = t_linalg.masked_cov(_t(Zc), _t(mask), mu=torch.zeros(D))
    np.testing.assert_allclose(_np(cov), _np(ref), rtol=1e-4, atol=1e-5)


def test_sharded_distance_histogram_counts_equal_jax(rng, cpu8):
    d = rng.uniform(0, 10, 64).astype(np.float32)
    mask = rng.random(64) > 0.2
    t_hist = t_penc.sharded_distance_histogram(cpu8, n_bins=64)
    j_hist = j_penc.sharded_distance_histogram(j_mesh.make_mesh(), n_bins=64)
    for lo, hi in ((0.0, 10.0), (2.5, 7.5), (3.0, 3.0)):  # all in range, both tails clipped, a zero-width range
        got = t_hist(d, mask, lo, hi)
        want = j_hist(jnp.asarray(d), jnp.asarray(mask), jnp.asarray(lo, jnp.float32), jnp.asarray(hi, jnp.float32))
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        assert float(got.sum()) == mask.sum()


def test_fit_radial_sharded_matches_both_packages(rng, cpu8):
    from anuraxla.detect.radial import fit_radial as j_fit_radial

    Z, mask = _rand_latents(rng)
    sh = t_pfit.fit_radial_sharded(Z, mask, 0.95, 0.15, mesh=cpu8)
    refs = (t_radial.fit_radial(_t(Z), _t(mask), 0.95, 0.15), j_fit_radial(jnp.asarray(Z), jnp.asarray(mask), 0.95, 0.15),
            j_pfit.fit_radial_sharded(Z, mask, 0.95, 0.15, mesh=j_mesh.make_mesh()))
    assert sh.rho_in_sorted.shape == (4, 56)  # the sample axis padded to the 8 shards
    for ref in refs:
        for name in ("centroids", "rk", "rk_in", "rk_out"):
            np.testing.assert_allclose(_np(getattr(sh, name)), _np(getattr(ref, name)), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        np.testing.assert_array_equal(_np(sh.n_in), _np(ref.n_in))
        np.testing.assert_array_equal(_np(sh.n_out), _np(ref.n_out))
        for k, n in enumerate(_np(ref.n_in)):
            np.testing.assert_allclose(_np(sh.rho_in_sorted)[k, :n], _np(ref.rho_in_sorted)[k, :n], rtol=1e-5, atol=1e-6)
    # identical decisions on the training latents
    flat, ranks = torch.from_numpy(Z[mask]), torch.arange(4, dtype=torch.int32)
    single = refs[0]
    a = t_radial.radial_decide(flat, sh.centroids, sh.rk, ranks)
    b = t_radial.radial_decide(flat, single.centroids, single.rk, ranks)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("cov_type,structure,tau_q", [
    ("lda", "full", 0.05), ("lda", "diag", 0.5), ("qda", "full", None), ("qda", "diag", 0.05),
])
def test_fit_map_sharded_matches_both_packages(rng, cpu8, cov_type, structure, tau_q):
    from anuraxla.detect.gaussian_map import fit_map as j_fit_map

    Z, mask = _rand_latents(rng)
    kw = dict(cov_type=cov_type, cov_structure=structure, priors_mode="empirical", eps=1e-5, shrink=0.1, tau_q=tau_q)
    sh = t_pfit.fit_map_sharded(Z, mask, mesh=cpu8, **kw)
    single = t_map.fit_map(_t(Z), _t(mask), **kw)
    for ref in (single, j_fit_map(jnp.asarray(Z), jnp.asarray(mask), **kw),
                j_pfit.fit_map_sharded(Z, mask, mesh=j_mesh.make_mesh(), **kw)):
        for name in ("means", "covs", "precisions", "logdets", "priors"):
            np.testing.assert_allclose(_np(getattr(sh, name)), _np(getattr(ref, name)), rtol=2e-4, atol=2e-5,
                                       err_msg=name)
        if tau_q is None:
            assert np.isnan(float(sh.tau))
        else:
            np.testing.assert_allclose(float(sh.tau), float(ref.tau), rtol=1e-4, atol=1e-5)
        n = int(ref.n_scores)
        assert int(sh.n_scores) == n
        np.testing.assert_allclose(_np(sh.scores_true_sorted)[:n], _np(ref.scores_true_sorted)[:n],
                                   rtol=2e-4, atol=2e-4)
    flat = torch.from_numpy(Z[mask])
    a = t_map.map_decide(flat, sh.means, sh.precisions, sh.logdets, sh.priors, sh.tau)
    b = t_map.map_decide(flat, single.means, single.precisions, single.logdets, single.priors, single.tau)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_sharded_quantile_exact(rng, cpu8):
    """Within 1 ulp of the sort path (``masked_quantile``) on non-grid q,
    ragged masks, heavy ties and a tiny-range row; equal to JAX's."""
    K, N = 4, 256
    d = rng.uniform(0.0, 7.0, (K, N)).astype(np.float32)
    d[2] = np.round(d[2] * 2.0) / 2.0
    d[3] = 1000.0 + d[3] * 1e-3
    mask = np.ones((K, N), bool)
    mask[1, 200:] = False
    for q in (0.2, 0.3337, 0.95, 0.0, 1.0):
        got = _np(t_pfit.sharded_quantile(d, mask, q, mesh=cpu8, n_bins=512, n_refine=2))
        exact = _np(t_q.masked_quantile(_t(d), _t(mask), q))
        np.testing.assert_allclose(got, exact, rtol=3e-7, atol=0.0, err_msg=f"q={q}")
        if q in (0.3337, 1.0):  # JAX's compiles once a q: two of them
            jgot = np.asarray(j_pfit.sharded_quantile(jnp.asarray(d), jnp.asarray(mask), q, mesh=j_mesh.make_mesh(),
                                                      n_bins=512, n_refine=2))
            np.testing.assert_allclose(got, jgot, rtol=3e-7, atol=0.0, err_msg=f"q={q}")
        ref = np.stack([np.quantile(d[k][mask[k]], q) for k in range(K)])
        np.testing.assert_allclose(got, ref, rtol=2e-6, atol=0.0, err_msg=f"q={q}")


def test_sharded_quantile_single_sample_empty_pool_and_alias(rng, cpu8):
    d = rng.uniform(0.0, 7.0, (1, 64)).astype(np.float32)
    mask = np.zeros((1, 64), bool)
    mask[0, 17] = True
    np.testing.assert_array_equal(_np(t_pfit.sharded_quantile(d, mask, 0.4, mesh=cpu8, n_bins=512)), d[0, 17:18])
    np.testing.assert_array_equal(_np(t_pfit.sharded_quantile_approx(d, mask, 0.4, mesh=cpu8)), d[0, 17:18])
    d2 = rng.uniform(0.0, 7.0, (2, 64)).astype(np.float32)
    m2 = np.ones((2, 64), bool)
    m2[1] = False
    got = _np(t_pfit.sharded_quantile(d2, m2, 0.2, mesh=cpu8, n_bins=512))
    assert np.isfinite(got[0]) and np.isinf(got[1])
    assert got[0] == _np(t_q.masked_quantile(_t(d2[:1]), _t(m2[:1]), 0.2))[0]
    assert _np(t_pfit.sharded_quantile(d2, m2, 0.2, mesh=cpu8, n_bins=512, empty_fill=0.0))[1] == 0.0


_JAX_STEP = {}


def _jax_two_steps(vcfg, tc, batch, key):
    """JAX's unsharded train step, twice (the first at lr 0: optax's warmup
    starts at 0), from the same init; cached across the parametrization."""
    if "res" not in _JAX_STEP:
        vae, state = j_train.create_train_state(vcfg, tc)
        init = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), state.params)
        step = jax.jit(j_train.make_train_step(vae, tc.beta))
        metrics = []
        for _ in range(2):
            state, m = step(state, jnp.asarray(batch), key)
            metrics.append(float(m["loss"]))
        _JAX_STEP["res"] = (init, state, metrics)
    return _JAX_STEP["res"]


@pytest.mark.parametrize("model_axis", [1, 2])
def test_sharded_train_step_matches_jax(rng, model_axis):
    """Two sharded steps over a (8 // model_axis) x model_axis CPU mesh from
    JAX's init with JAX's noise, against JAX's unsharded steps and the port's:
    the global batch's loss and the parameters after. At model_axis 2 the
    dense bottleneck (and the decoder's wide dense) are split."""
    kw = dict(latent_dim=16, widths=(8, 128), dense_width=256, groups=4, input_hw=(16, 16))
    jtc = j_train.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, beta=0.1, seed=0)
    batch = rng.standard_normal((8, 16, 16, 1)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    init, jstate, jloss = _jax_two_steps(j_vae.VAEConfig(**kw), jtc, batch, key)

    tcfg = t_vae.VAEConfig(**kw)
    slots = list(t_convert.vae_slots(tcfg))
    ttc = t_train.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, beta=0.1, seed=0)
    init_state = t_convert.state_from_jax(init, slots)
    _, state = t_train.create_train_state(tcfg, ttc, init_params=init_state, device="cpu")
    _, plain = t_train.create_train_state(tcfg, ttc, init_params=init_state, device="cpu")
    mesh = t_mesh.make_mesh(devices=["cpu"] * 8, model_axis=model_axis)
    ss, shardings = t_ts.shard_state(state, mesh)
    split = {k for k, v in shardings.items() if v == "model"}
    if model_axis > 1:
        assert {"encoder.dense.weight", "decoder.dense1.weight"} <= split
        assert isinstance(ss.replicas[0].encoder.dense, t_ts.ColumnSplitDense)
    else:
        assert not split
    step = t_ts.make_sharded_train_step(ttc.beta, mesh)
    pstep = t_train.make_train_step(ttc.beta)
    for k in range(2):
        eps = torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, k), (8, 16), jnp.float32)))
        ss, m = step(ss, torch.from_numpy(batch), eps)
        plain, pm = pstep(plain, torch.from_numpy(batch), eps)
        np.testing.assert_allclose(float(m["loss"]), jloss[k], rtol=1e-4)
        np.testing.assert_allclose(float(m["loss"]), float(pm["loss"]), rtol=1e-4)
    assert ss.state.step == 2
    got = t_convert.params_for_jax(ss.state.model.state_dict(), slots)
    for a, b in zip(jax.tree_util.tree_leaves(jstate.params), jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=2e-3, atol=2e-4)
    for (name, a), b in zip(plain.model.state_dict().items(), ss.state.model.state_dict().values()):
        np.testing.assert_allclose(_np(b), _np(a), rtol=2e-3, atol=2e-4, err_msg=name)
    # every replica holds the master's parameters again
    for rep, binds in zip(ss.replicas, ss.binds):
        for p, parts in binds:
            for rp, rows in parts:
                assert torch.equal(rp, p if rows is None else p[rows])


def test_train_loop_sharded_logs_and_returns_a_plain_state(tmp_path, monkeypatch):
    from anuraxla_torch.utils.metrics import reset_metrics_sink

    cfg = t_vae.VAEConfig(latent_dim=8, widths=(8,), dense_width=16, groups=4, input_hw=(16, 16))
    tc = t_train.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=3, beta=0.1, kl_delay_steps=1,
                             kl_warmup_steps=2, seed=2)
    batches = [np.random.default_rng(i).standard_normal((4, 16, 16, 1)).astype(np.float32) for i in range(3)]
    mesh = t_mesh.make_mesh(devices=["cpu"] * 4, model_axis=2)
    lines = []
    monkeypatch.setenv("ANURAXLA_METRICS_FILE", str(tmp_path / "metrics.jsonl"))
    reset_metrics_sink()
    try:
        vae, state, metrics = t_ts.train_loop_sharded(cfg, tc, iter(batches), mesh=mesh, log_every=1,
                                                      log_fn=lines.append)
    finally:
        monkeypatch.delenv("ANURAXLA_METRICS_FILE")
        reset_metrics_sink()
    _, pstate, pmetrics = t_train.train_loop(cfg, tc, iter(batches), log_every=0, device="cpu")
    assert [ln.split(":")[0] for ln in lines] == ["step 0 [2dp x 2tp]", "step 1 [2dp x 2tp]", "step 2 [2dp x 2tp]"]
    assert state.step == pstate.step == 3 and isinstance(vae, t_vae.ConvVAE)
    np.testing.assert_allclose(metrics["loss"], pmetrics["loss"], rtol=1e-4)
    enc = t_vae.encoder_params_from_vae(state.model.state_dict())
    assert set(enc) == set(t_vae.ConvVAEEncoder(cfg).state_dict())
    records = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["kind"], r["dp"], r["tp"]) for r in records] == [("train", 2, 2)] * 3


def _session_pair(tmp_path, **kw):
    from anuraxla_torch.models.checkpoint import save_encoder
    from anuraxla_torch.pipeline.session import EncoderSession

    mel = kw.pop("mel", MelConfig(**TOY_MEL))
    vcfg = kw.pop("vcfg", t_vae.VAEConfig(**dict(TOY_ENC, latent_dim=8, dense_width=16)))
    enc = tmp_path / "enc"
    if not enc.exists():
        save_encoder(enc, vcfg, t_vae.init_encoder_params(vcfg, torch.Generator().manual_seed(0)))
    base = dict(mel=mel, encoder_dir=enc, project_root=tmp_path, device="cpu", **kw)
    return (lambda dp, **more: EncoderSession(data_parallel=dp, **{**base, **more}).load()), mel


def test_session_data_parallel_matches_single(tmp_path, rng, cpu8, capsys):
    make, mel = _session_pair(tmp_path)
    batch = (0.1 * rng.standard_normal((16, mel.num_samples))).astype(np.float32)
    s1, s8 = make(False, batch_size=16), make(True, batch_size=16)
    assert s1._mesh is None and s8._mesh.shape == {"data": 8, "model": 1}
    np.testing.assert_allclose(s8.encode_array(batch), s1.encode_array(batch), rtol=2e-4, atol=2e-5)
    # a ragged batch is padded to the shard multiple and sliced back
    np.testing.assert_allclose(s8.encode_array(batch[:5]), s1.encode_array(batch[:5]), rtol=2e-4, atol=2e-5)
    s9 = make(True, batch_size=9)
    assert s9.batch_size == 16  # the next multiple of the 8-shard data axis
    assert "batch_size rounded up to 16 (8-way even shards)" in capsys.readouterr().out
    # one shard (the CPU's default mesh): the single-device path, bitwise
    t_mesh.set_default_devices(None)
    s_one = make(True, batch_size=16)
    assert s_one._mesh is None
    assert np.array_equal(s_one.encode_array(batch), s1.encode_array(batch))


def test_fit_trees_and_benchmark_data_parallel_e2e(tmp_path, cpu8):
    """fit_radial_tree / fit_map_tree / run_folder_benchmark with a
    data-parallel session over 8 CPU shards write the numbers the single
    session writes (the counterpart of test_fit_tree_data_parallel_e2e)."""
    from anuraxla_torch.cli.make_synth_data import make_tree
    from anuraxla_torch.constants import SPECIES
    from anuraxla_torch.pipeline.benchmark import run_folder_benchmark
    from anuraxla_torch.pipeline.fit import _use_sharded_fit, fit_map_tree, fit_radial_tree

    mel = MelConfig(sr=16000, duration=0.5, target_frames=48, n_mels=32, fmax=7000)
    vcfg = t_vae.VAEConfig(latent_dim=8, widths=(8, 16), dense_width=16, groups=4, input_hw=(48, 32))
    make, _ = _session_pair(tmp_path, mel=mel, vcfg=vcfg)
    make_tree(tmp_path / "chunks", sr=mel.sr, seconds=mel.duration, per_species=8, seed=3)

    def run(dp: bool, tag: str):
        cfgp = tmp_path / f"config_{tag}.json"
        cfgp.write_text(json.dumps({"species": list(SPECIES), "chunk_seconds": mel.duration}))
        s = make(dp, batch_size=8)
        assert _use_sharded_fit(s) == dp
        kw = dict(cfg_path=cfgp, chunks_dir=tmp_path / "chunks" / "train_chunks", session=s, cache=False,
                  cache_dir=None, max_per_class=0, seed=1, log=lambda *a: None)
        r = fit_radial_tree(cfg=json.loads(cfgp.read_text()), q_in=0.9, q_out=0.2, **kw)
        m = fit_map_tree(cfg=json.loads(cfgp.read_text()), cov_type="lda", cov_structure="full",
                         priors_mode="empirical", eps=1e-6, shrink=0.0, tau_q=0.05, **kw)
        res = run_folder_benchmark(root=tmp_path / "chunks" / "val_chunks", config_path=cfgp, detector="radial",
                                   session=s, out_dir=tmp_path / f"bench_{tag}", log=lambda *a: None,
                                   write_artifacts=False)
        return json.loads(cfgp.read_text()), res, r, m

    c1, r1, rad1, map1 = run(False, "single")
    c8, r8, rad8, map8 = run(True, "dp")
    assert r1.total == r8.total and abs(r1.accuracy - r8.accuracy) < 1e-9
    assert rad8["fit"].rho_in_sorted.shape[1] % 8 == 0
    for sp in SPECIES:
        assert abs(c1["radial_detector"]["thresholds"][sp] - c8["radial_detector"]["thresholds"][sp]) < 1e-4
        np.testing.assert_allclose(c1["map_detector"]["means"][sp], c8["map_detector"]["means"][sp],
                                   rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(c1["map_detector"]["tau"], c8["map_detector"]["tau"], rtol=2e-3, atol=2e-3)
    for a, b in ((rad1, rad8), (map1, map8)):
        np.testing.assert_allclose(a["Z"], b["Z"], rtol=2e-4, atol=2e-5)


def test_run_qout_grid_device_sweep_data_parallel(tmp_path, cpu8, monkeypatch, capsys):
    """run-qout-grid --device-sweep --data-parallel over 8 CPU shards: the
    sharded fit, and the val latents padded with the pad rows masked; the
    grid equal to the run without the flag (1e-7: a rate divided by the
    valid count, not multiplied by the reciprocal; tests/test_parallel.py:361)."""
    import csv

    from anuraxla_torch.cli import run_qout_grid as t_grid
    from anuraxla_torch.cli.make_synth_data import make_tree
    from anuraxla_torch.constants import SPECIES

    mel = MelConfig(sr=16000, duration=0.5, target_frames=48, n_mels=32, fmax=7000)
    vcfg = t_vae.VAEConfig(latent_dim=8, widths=(8, 16), dense_width=16, groups=4, input_hw=(48, 32))
    _session_pair(tmp_path, mel=mel, vcfg=vcfg)  # writes the encoder artifact
    make_tree(tmp_path / "chunks", sr=mel.sr, seconds=mel.duration, per_species=4, seed=4)
    (tmp_path / "models").mkdir()
    (tmp_path / "config.json").write_text(json.dumps({"species": list(SPECIES), "chunk_seconds": mel.duration}))
    monkeypatch.chdir(tmp_path)
    argv = ["--train-root", "chunks/train_chunks", "--val-root", "chunks/val_chunks", "--q-out-grid", "0.2",
            "--device-sweep", "--q-in-grid", "0.8", "0.9", "--device", "cpu", "--encoder", str(tmp_path / "enc"),
            "--batch-size", "8", "--sr", "16000", "--n-mels", "32", "--target-frames", "48", "--fmax", "7000"]
    rows = {}
    for dp in (False, True):
        t_grid.main(argv + ["--grid-root", f"grid{int(dp)}"] + ["--data-parallel"] * dp)
        out = capsys.readouterr().out
        assert ("device sweep sharded over 8 shards" in out) is dp
        with open(tmp_path / f"grid{int(dp)}" / "grid_metrics.csv", newline="") as f:
            rows[dp] = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]
    assert len(rows[True]) == len(rows[False]) == 2
    for a, b in zip(rows[False], rows[True]):
        assert a.keys() == b.keys()
        np.testing.assert_allclose(list(b.values()), list(a.values()), rtol=0, atol=1e-7)


def test_radial_qgrid_sharded_pad_rows_masked(rng, cpu8):
    """The device sweep's data-parallel branch: val latents padded to the
    data axis with the pad rows masked out equals the unpadded sweep."""
    from anuraxla_torch.detect.calibrate import radial_qgrid

    Z, mask = _rand_latents(rng)
    fit = t_pfit.fit_radial_sharded(Z, mask, 0.9, 0.2, mesh=cpu8)
    B, D = 42, Z.shape[-1]  # not divisible by 8: exercises the pad + mask path
    Zv = rng.standard_normal((B, D)).astype(np.float32) + 1.0
    true_idx = rng.integers(0, 4, B).astype(np.int32)
    ranks, qi, qo = torch.arange(4, dtype=torch.int32), np.asarray([0.8, 0.9], np.float32), np.asarray([0.1, 0.2],
                                                                                                        np.float32)
    ref = radial_qgrid(fit, _t(Zv), _t(true_idx), ranks, qi, qo)
    Zp, _ = t_mesh.pad_to_multiple(Zv, 8)
    tp, _ = t_mesh.pad_to_multiple(true_idx, 8)
    sh = radial_qgrid(fit, _t(Zp), _t(tp), ranks, qi, qo, torch.arange(Zp.shape[0]) < B)
    for name in ("accuracy", "no_detect_rate", "acc_per_class", "no_detect_per_class", "thresholds"):
        np.testing.assert_array_equal(_np(getattr(sh, name)), _np(getattr(ref, name)), err_msg=name)
    # and the JAX package's unsharded sweep on its own fit agrees
    from anuraxla.detect.calibrate import radial_qgrid as j_radial_qgrid
    from anuraxla.detect.radial import fit_radial as j_fit_radial

    jfit = j_fit_radial(jnp.asarray(Z), jnp.asarray(mask), 0.9, 0.2)
    jref = j_radial_qgrid(jfit, jnp.asarray(Zv), jnp.asarray(true_idx), jnp.arange(4, dtype=jnp.int32), qi, qo)
    np.testing.assert_allclose(_np(sh.accuracy), np.asarray(jref.accuracy), atol=1e-7)


def test_multihost_helpers_single_process(monkeypatch, cpu8):
    from pathlib import Path

    from anuraxla.parallel.multihost import shard_paths_for_host as j_shard

    for var in t_multihost.LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)
    assert t_multihost.initialize_multihost(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert t_multihost.global_mesh(device="cpu").shape == {"data": 8, "model": 1}
    assert t_multihost.global_mesh(model_axis=4, device="cpu").shape == {"data": 2, "model": 4}
    paths = [Path(f"f{i:03d}.wav") for i in range(23)]
    assert t_multihost.shard_paths_for_host(paths) == paths == j_shard(paths)
    shards = [t_multihost.shard_paths_for_host(paths, process_index=i, process_count=4) for i in range(4)]
    assert shards == [j_shard(paths, process_index=i, process_count=4) for i in range(4)]
    flat = [p for s in shards for p in s]
    assert sorted(flat) == sorted(paths) and len(set(flat)) == len(paths)
    assert max(map(len, shards)) - min(map(len, shards)) <= 1


# every CLI whose JAX parser has a build_parser: (JAX module, port module)
CLIS = ["benchmark_folder", "calibrate_tau", "encode_wav", "evaluate_wav", "evaluate_wav_map", "fit_map",
        "fit_radial", "run_qout_grid", "scan_soundscape"]
REQUIRED = {"encode_wav": ["--wav", "x.wav"], "evaluate_wav": ["--wav", "x.wav"],
            "evaluate_wav_map": ["--wav", "x.wav"], "scan_soundscape": ["--root", "r"], "fit_map": ["--root", "r"],
            "fit_radial": ["--root", "r"]}


def _jax_parser_of_main(module):
    """The parser a JAX CLI builds inside its ``main`` (train_vae has no
    build_parser): the first parse_args call is caught."""
    class Caught(Exception):
        pass

    seen = {}

    def grab(self, args=None, namespace=None):
        seen["p"] = self
        raise Caught

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        module.main()
    except Caught:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen["p"]


@pytest.mark.parametrize("name", CLIS)
def test_cli_flags_parse_under_both_packages(name):
    """The same command line parses under both packages' parsers:
    ``--allow-init-encoder`` wherever ``add_encoder_args`` runs (a hidden
    no-op, on by default), and ``--data-parallel`` wherever the JAX parser
    takes it, carried into the session's kwargs."""
    import importlib

    jp = importlib.import_module(f"anuraxla.cli.{name}").build_parser()
    tp = importlib.import_module(f"anuraxla_torch.cli.{name}").build_parser()
    argv = REQUIRED.get(name, []) + ["--allow-init-encoder"]
    assert jp.parse_args(argv).allow_init_encoder is tp.parse_args(argv).allow_init_encoder is True
    assert tp.parse_args(REQUIRED.get(name, [])).allow_init_encoder is True
    assert "--allow-init-encoder" not in tp.format_help()
    if "--data-parallel" in jp.format_help():
        ta = tp.parse_args(argv + ["--data-parallel"])
        assert jp.parse_args(argv + ["--data-parallel"]).data_parallel is ta.data_parallel is True
        if hasattr(ta, "batch_size"):
            from anuraxla_torch.cli.common import session_kwargs

            assert session_kwargs(ta)["data_parallel"] is True


def test_train_vae_and_qout_grid_take_data_parallel(monkeypatch):
    from anuraxla.cli import train_vae as j_train_cli
    from anuraxla_torch.cli import run_qout_grid as t_grid
    from anuraxla_torch.cli import train_vae as t_train_cli

    monkeypatch.setattr("sys.argv", ["train-vae"])
    jp = _jax_parser_of_main(j_train_cli)
    argv = ["--root", "r", "--data-parallel"]
    assert jp.parse_args(argv).data_parallel is t_train_cli.build_parser().parse_args(argv).data_parallel is True
    for argv, want in (([], False), (["--data-parallel"], True)):
        shared = t_grid.subprocess_shared_args(t_grid.build_parser().parse_args(argv), "c.json")
        assert ("--data-parallel" in shared) is want
