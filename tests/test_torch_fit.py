"""The port's fit path held against the JAX package on the CPU: quantiles,
linalg (with the non-PD repair), the radial and Gaussian-MAP fits and
decisions, the config.json blocks read and written by either package,
``fit_radial_tree`` / ``fit_map_tree`` end to end on a tiny tree through the
port's CLIs against the JAX package's fits, and three repairs — the
device-aware cache-key name, ``--config`` resolved against the project root,
and the species-tree cache.

Tolerances: where both sides are f32 with the same sum order, rtol 1e-6;
otherwise the JAX suite's own (``tests/test_detect.py:52-55``, ``:128-132``,
``:148``); decisions are identical."""

import json
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anuraxla import config as j_config
from anuraxla.cli import evaluate_wav as j_eval
from anuraxla.cli.evaluate_wav_map import detect_species_map as j_detect_map
from anuraxla.constants import MelConfig as JMel
from anuraxla.detect import gaussian_map as j_map
from anuraxla.detect import radial as j_radial
from anuraxla.models.checkpoint import save_encoder as j_save_encoder
from anuraxla.models.vae import VAEConfig as JVAEConfig
from anuraxla.models.vae import init_encoder as j_init_encoder
from anuraxla.ops import linalg as j_linalg
from anuraxla.ops import quantiles as j_q
from anuraxla.pipeline import fit as j_fit
from anuraxla.pipeline.session import EncoderSession as JSession
from anuraxla.pipeline.session import concat_species_latents as j_concat
from anuraxla.pipeline.session import encode_species_tree as j_encode_tree
from anuraxla_torch import config as t_config
from anuraxla_torch.cli import evaluate_wav as t_eval
from anuraxla_torch.cli import evaluate_wav_map as t_eval_map
from anuraxla_torch.cli import fit_map as t_fit_map_cli
from anuraxla_torch.cli import fit_radial as t_fit_radial_cli
from anuraxla_torch.constants import MelConfig
from anuraxla_torch.detect import gaussian_map as t_map
from anuraxla_torch.detect import radial as t_radial
from anuraxla_torch.ops import frontend as tfe
from anuraxla_torch.ops import linalg as t_linalg
from anuraxla_torch.ops import quantiles as t_q
from anuraxla_torch.pipeline.session import EncoderSession, concat_species_latents, encode_species_tree
from anuraxla_torch.utils.wavio import write_wav

SPECIES = ["Batrachyla_leptopus", "Batrachyla_taeniata", "Calyptocephalella_gayi"]
SMALL = dict(sr=16000, duration=0.5, n_mels=32, fmin=100.0, fmax=7500.0, hop_length=128, n_fft=256,
             target_frames=48)
MEL_ARGS = ["--sr", "16000", "--n-mels", "32", "--target-frames", "48", "--fmin", "100", "--fmax", "7500",
            "--hop-length", "128", "--n-fft", "256"]
NARROW = dict(latent_dim=8, widths=(8, 16), dense_width=32, groups=4, input_hw=(48, 32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _n(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def make_ragged(seed, K=4, D=8, ns=(20, 13, 7, 17)):
    """Padded [K, Nmax, D] latents with distinct cluster means (the JAX suite's helper)."""
    rng = np.random.default_rng(seed)
    Nmax = max(ns)
    Z = np.zeros((K, Nmax, D), np.float32)
    mask = np.zeros((K, Nmax), bool)
    centers = rng.standard_normal((K, D)).astype(np.float32) * 4
    for k, n in enumerate(ns):
        Z[k, :n] = centers[k] + 0.5 * rng.standard_normal((n, D)).astype(np.float32)
        mask[k, :n] = True
    return Z, mask


@pytest.mark.parametrize("q", [0.0, 0.01, 0.37, 0.5, 0.95, 1.0, [0.05, 0.5, 0.95]])
def test_masked_quantile_matches_jax(q):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 11)).astype(np.float32)
    mask = rng.random((5, 11)) > 0.3
    mask[3] = False  # an empty row gives 0.0
    mask[4] = False
    mask[4, 2] = True  # one valid entry
    got = _n(t_q.masked_quantile(_t(x), _t(mask), q))
    want = np.asarray(j_q.masked_quantile(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(q, jnp.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.all(got[3] == 0.0)
    for row in (0, 1, 2):
        np.testing.assert_allclose(got[row], np.quantile(x[row][mask[row]], q), rtol=1e-5)
    with pytest.raises(ValueError):
        t_q.masked_quantile(_t(x), _t(mask), [[0.5]])


def test_quantile_sorted_matches_jax():
    rng = np.random.default_rng(2)
    xs = np.sort(np.where(rng.random((4, 9)) > 0.2, rng.standard_normal((4, 9)), np.inf), axis=1).astype(np.float32)
    n = np.isfinite(xs).sum(1)
    for q in (0.0, 0.25, 0.9, 1.0):
        got = _n(t_q.quantile_sorted(_t(xs), q, _t(n)))
        want = np.asarray(j_q.quantile_sorted(jnp.asarray(xs), jnp.asarray(q, jnp.float32), jnp.asarray(n)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_linalg_matches_jax_with_the_non_pd_repair():
    rng = np.random.default_rng(3)
    Z = rng.standard_normal((12, 5)).astype(np.float32)
    mask = rng.random(12) > 0.25
    np.testing.assert_allclose(_n(t_linalg.masked_mean(_t(Z), _t(mask))),
                               np.asarray(j_linalg.masked_mean(jnp.asarray(Z), jnp.asarray(mask))), rtol=1e-6)
    cov = _n(t_linalg.masked_cov(_t(Z), _t(mask)))
    np.testing.assert_allclose(cov, np.asarray(j_linalg.masked_cov(jnp.asarray(Z), jnp.asarray(mask))),
                               rtol=1e-5, atol=1e-6)
    one = np.zeros(12, bool)
    one[4] = True
    assert np.array_equal(_n(t_linalg.masked_cov(_t(Z), _t(one))), np.eye(5, dtype=np.float32))  # < 2 rows: I
    for kw in (dict(eps=1e-4, shrink=0.0), dict(eps=1e-6, shrink=0.3), dict(eps=1e-6, shrink=0.1, diag_only=True)):
        np.testing.assert_allclose(_n(t_linalg.regularize_cov(_t(cov), **kw)),
                                   np.asarray(j_linalg.regularize_cov(jnp.asarray(cov), **kw)), rtol=1e-6)
    # a PD matrix, one that only the +1e-3·I retry factors, and one that neither does
    q, _ = np.linalg.qr(rng.standard_normal((5, 5)))
    mats = np.stack([q @ np.diag(ev) @ q.T for ev in ([1.0, 2, 3, 0.5, 0.1], [1.0, 2, 3, 0.5, -5e-4],
                                                      [1.0, 2, 3, 0.5, -0.5])]).astype(np.float32)
    mats = (mats + mats.transpose(0, 2, 1)) / 2
    prec, ld = (_n(v) for v in t_linalg.inv_and_logdet(_t(mats)))
    jprec, jld = (np.asarray(v) for v in j_linalg.inv_and_logdet(jnp.asarray(mats)))
    np.testing.assert_allclose(prec[:2], jprec[:2], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(ld[:2], jld[:2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ld[1], np.log(np.linalg.eigvalsh(mats[1].astype(np.float64) + 1e-3 * np.eye(5))).sum(),
                               rtol=1e-3)
    assert np.isnan(ld[2]) and np.isnan(jld[2])
    ll = _n(t_linalg.gaussian_log_likelihood(_t(Z), _t(Z[:2]), _t(prec[:2]), _t(ld[:2])))
    jll = np.asarray(j_linalg.gaussian_log_likelihood(jnp.asarray(Z), jnp.asarray(Z[:2]), jnp.asarray(prec[:2]),
                                                      jnp.asarray(ld[:2])))
    np.testing.assert_allclose(ll, jll, rtol=1e-5, atol=1e-4)


def test_fit_radial_and_thresholds_match_jax():
    Z, mask = make_ragged(4)
    q_in, q_out = 0.95, 0.10
    fit = t_radial.fit_radial(_t(Z), _t(mask), q_in, q_out)
    jfit = j_radial.fit_radial(jnp.asarray(Z), jnp.asarray(mask), q_in, q_out)
    np.testing.assert_allclose(_n(fit.centroids), np.asarray(jfit.centroids), rtol=1e-5, atol=1e-5)
    for name in ("rk", "rk_in", "rk_out"):
        np.testing.assert_allclose(_n(getattr(fit, name)), np.asarray(getattr(jfit, name)), rtol=1e-4, atol=1e-5)
    for name in ("n_in", "n_out"):
        assert np.array_equal(_n(getattr(fit, name)), np.asarray(getattr(jfit, name)))
    for name in ("rho_in_sorted", "rho_out_sorted"):
        np.testing.assert_allclose(_n(getattr(fit, name)), np.asarray(getattr(jfit, name)), rtol=1e-4, atol=1e-5)
    for qi, qo in ((0.5, 0.01), (0.99, 0.3)):
        np.testing.assert_allclose(_n(t_radial.thresholds_for_q(fit, qi, qo)),
                                   np.asarray(j_radial.thresholds_for_q(jfit, qi, qo)), rtol=1e-4, atol=1e-5)
    # one species alone: no out-of-class pool, rk_out = inf
    solo = t_radial.fit_radial(_t(Z[:1]), _t(mask[:1]), q_in, q_out)
    assert np.isinf(_n(solo.rk_out)).all() and np.array_equal(_n(solo.rk), _n(solo.rk_in))
    # decisions on every training latent, with the port's fit or the JAX one
    flat = Z[mask]
    ranks = t_config.priority_ranks(SPECIES + ["Pleurodema_thaul"])
    dt = [_n(v) for v in t_radial.radial_decide(_t(flat), fit.centroids, fit.rk, _t(ranks))]
    dj = [np.asarray(v) for v in j_radial.radial_decide(jnp.asarray(flat), jfit.centroids, jfit.rk, jnp.asarray(ranks))]
    assert np.array_equal(dt[0], dj[0]) and np.array_equal(dt[1], dj[1]) and dt[0].any() and not dt[0].all()


@pytest.mark.parametrize("cov_type", ["lda", "qda"])
@pytest.mark.parametrize("cov_structure", ["full", "diag"])
@pytest.mark.parametrize("priors_mode", ["empirical", "uniform"])
def test_fit_map_matches_jax(cov_type, cov_structure, priors_mode):
    Z, mask = make_ragged(5)
    kw = dict(cov_type=cov_type, cov_structure=cov_structure, priors_mode=priors_mode, eps=1e-4, shrink=0.1,
              tau_q=0.05)
    fit = t_map.fit_map(_t(Z), _t(mask), **kw)
    jfit = j_map.fit_map(jnp.asarray(Z), jnp.asarray(mask), **kw)
    np.testing.assert_allclose(_n(fit.means), np.asarray(jfit.means), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_n(fit.covs), np.asarray(jfit.covs), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(_n(fit.priors), np.asarray(jfit.priors), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_n(fit.logdets), np.asarray(jfit.logdets), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_n(fit.precisions), np.asarray(jfit.precisions), rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(float(fit.tau), float(jfit.tau), rtol=1e-3, atol=1e-3)
    assert int(fit.n_scores) == int(jfit.n_scores) == mask.sum()
    np.testing.assert_allclose(_n(fit.scores_true_sorted)[: mask.sum()],
                               np.asarray(jfit.scores_true_sorted)[: mask.sum()], rtol=1e-3, atol=1e-3)
    summ = t_map.true_class_score_summary(fit, _t(Z), _t(mask))
    jsumm = j_map.true_class_score_summary(jfit, jnp.asarray(Z), jnp.asarray(mask))
    for key in ("min", "p05", "p50", "p95", "max"):
        np.testing.assert_allclose(_n(summ[key]), np.asarray(jsumm[key]), rtol=1e-3, atol=1e-3)
    # decisions on every training latent and on far points, tau on and off
    probe = np.concatenate([Z[mask], 30.0 * np.ones((2, Z.shape[2]), np.float32)])
    for tau in (fit.tau, torch.tensor(float("nan"))):
        dt = [_n(v) for v in t_map.map_decide(_t(probe), fit.means, fit.precisions, fit.logdets, fit.priors, tau)]
        dj = [np.asarray(v) for v in j_map.map_decide(jnp.asarray(probe), jfit.means, jfit.precisions,
                                                        jfit.logdets, jfit.priors, jnp.asarray(_n(tau)))]
        assert np.array_equal(dt[0], dj[0]) and np.array_equal(dt[1], dj[1])
        np.testing.assert_allclose(dt[2], dj[2], rtol=1e-3, atol=1e-3)
        assert dt[0][-1] == bool(torch.isnan(tau))  # a far point: rejected by tau, else detected


def test_map_tau_disabled_detects_everything():
    Z, mask = make_ragged(6)
    fit = t_map.fit_map(_t(Z), _t(mask))
    assert torch.isnan(fit.tau)
    det, win, _ = t_map.map_decide(_t(Z[mask]), fit.means, fit.precisions, fit.logdets, fit.priors, fit.tau)
    assert bool(det.all()) and bool((win >= 0).all())


def _blocks(rng, K=3, D=4):
    sp = SPECIES[:K]
    cent, rk = rng.standard_normal((K, D)).astype(np.float32), rng.random(K).astype(np.float32)
    covs = np.stack([np.eye(D, dtype=np.float32) * (k + 1) for k in range(K)])
    return sp, cent, rk, covs, np.linalg.inv(covs), np.log(np.arange(1, K + 1, dtype=np.float32)) * D


def test_config_blocks_round_trip_between_packages(tmp_path):
    """Each package reads the blocks the other writes; ``.bak`` backups."""
    rng = np.random.default_rng(7)
    sp, cent, rk, covs, precs, lds = _blocks(rng)
    priors = np.array([0.5, 0.3, 0.2], np.float32)
    meta = {s: {"prior": float(p)} for s, p in zip(sp, priors)}
    common = dict(chunks_dir=tmp_path / "chunks", max_per_class=3, seed=9)
    for writer, reader in ((t_config, j_config), (j_config, t_config)):
        path = tmp_path / f"{writer.__name__}.json"
        base = {"species": sp, "chunk_seconds": 0.5, "other": [1, 2]}
        path.write_text(json.dumps(base))
        mel_cls = MelConfig if writer is t_config else JMel
        mel = mel_cls(**SMALL)
        bak = writer.write_radial(path, dict(base), sp, cent, rk, mel=mel, q_in=0.9, q_out=0.05,
                                  per_species_meta={s: {"N_in": 3} for s in sp}, **common, augment_noise_db=[6.0])
        assert json.loads(bak.read_text()) == base
        cfg = json.loads(path.read_text())
        got_radial = json.loads(path.read_text())  # write_map adds its block to cfg in place
        got = reader.read_radial(cfg)
        assert got[0] == sp and np.array_equal(got[1], cent) and np.array_equal(got[2], rk) and got[3] == 0.5
        writer.write_map(path, cfg, sp, cent, covs, precs, lds, priors, -3.25, cov_type="qda", cov_structure="diag",
                         priors_mode="empirical", mel=mel.replace(duration=2.0), eps=1e-6, shrink=0.1, tau_q=0.01,
                         score_true_global_summary={"min": -1.0}, per_species_meta=meta, **common)
        cfg2 = json.loads(path.read_text())
        got_m, want_m = reader.read_map(cfg2), (sorted(sp), cent, precs, lds, priors, -3.25, 2.0)
        assert got_m[0] == want_m[0] and got_m[5:] == want_m[5:]
        for a, b in zip(got_m[1:5], want_m[1:5]):
            np.testing.assert_allclose(a, b, rtol=1e-6)
        assert cfg2["other"] == [1, 2] and "radial_detector" in cfg2
        assert json.loads((tmp_path / f"{writer.__name__}.json.bak").read_text()) == json.loads(json.dumps(got_radial))
    t_cfg, j_cfg = (json.loads((tmp_path / f"{m.__name__}.json").read_text()) for m in (t_config, j_config))
    assert t_cfg == j_cfg  # the same blocks, field for field
    assert t_config.require_species({"species": ["a"]}) == ["a"]
    with pytest.raises(SystemExit):
        t_config.require_species({"species": "a"})


def test_arithmetic_backend_names_the_device():
    """A kernel backend names another arithmetic on the CPU (the plain
    version) than on the card (the tensor-core split), so their latent caches
    get different keys; matmul and the no-kernel configs do not split."""
    mel = MelConfig()
    for b in ("cuda", "cuda-bf16"):
        on_card, on_cpu = tfe.arithmetic_backend(mel, b, "cuda"), tfe.arithmetic_backend(mel, b, "cpu")
        assert on_card == b and on_cpu == f"{b}-cpuplain" != on_card
        assert tfe.arithmetic_backend(mel, b, torch.device("cuda", 0)) == b
    for b in ("matmul", "matmul-bf16"):
        assert tfe.arithmetic_backend(mel, b, "cuda") == tfe.arithmetic_backend(mel, b, "cpu") == b
    odd = mel.replace(hop_length=441)  # no kernel takes it: matmul math on both
    assert tfe.arithmetic_backend(odd, "cuda", "cpu") == tfe.arithmetic_backend(odd, "cuda", "cuda") == "matmul"


def _tree(root, n_per=6, held_out=2):
    """root/<species>/*.wav: a tone band per species plus noise; and held-out WAVs."""
    rng = np.random.default_rng(11)
    mel = MelConfig(**SMALL)
    t = np.arange(mel.num_samples) / mel.sr
    held = []
    for k, sp in enumerate(SPECIES):
        (root / "chunks" / sp).mkdir(parents=True)
        for i in range(n_per + held_out):
            f = 800 + 2000 * k + 150 * rng.standard_normal()
            y = 0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(t.size)
            p = root / "chunks" / sp / f"c{i:02d}.wav" if i < n_per else root / f"held_{k}_{i}.wav"
            write_wav(p, y.astype(np.float32), mel.sr)
            if i >= n_per:
                held.append(p)
    return held


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """A project root: config.json, the default encoder artifact (written by
    the JAX package), a species tree and held-out WAVs."""
    root = tmp_path_factory.mktemp("project")
    held = _tree(root)
    jcfg = JVAEConfig(**NARROW)
    _, params = j_init_encoder(jcfg, seed=5)
    j_save_encoder(root / "models" / "anuraxla_vae_encoder_v0", jcfg, params)
    (root / "config.json").write_text(json.dumps({"species": SPECIES + ["Pleurodema_thaul"], "chunk_seconds": 0.5}))
    return root, held


def _jsession(root):
    return JSession(mel=JMel(**SMALL), backend="matmul", project_root=root, batch_size=4).load()


def test_fit_trees_end_to_end_match_jax(project, tmp_path, monkeypatch, capsys):
    """The port's fit-radial and fit-map CLIs (subsampled, cached) against the
    JAX package's ``fit_radial_tree`` / ``fit_map_tree`` on the same tree and
    artifact; then evaluate-wav-map's exit codes on held-out WAVs against the
    JAX package's decisions from the port's file."""
    root, held = project
    monkeypatch.chdir(root)
    common = ["--root", "chunks", "--device", "cpu", "--frontend-backend", "matmul", "--batch-size", "4",
              "--max-per-class", "5", "--seed", "7", "--cache", *MEL_ARGS]
    t_fit_radial_cli.main(common + ["--q-in", "0.9", "--q-out", "0.05"])
    out = capsys.readouterr().out
    t_fit_map_cli.main(common + ["--cov-type", "qda", "--preset", "small-n", "--set-tau-q", "0.1"])
    out_map = capsys.readouterr().out
    assert out_map.count("🧊") == len(SPECIES)  # the radial fit's archives, read back
    tcfg = json.loads((root / "config.json").read_text())

    jroot = tmp_path / "j"
    jroot.mkdir()
    jcfg_path = jroot / "config.json"
    jcfg_path.write_text(json.dumps({"species": SPECIES + ["Pleurodema_thaul"], "chunk_seconds": 0.5}))
    js = _jsession(root)
    lines = []
    kw = dict(cfg_path=jcfg_path, chunks_dir=root / "chunks", session=js, cache=False, cache_dir=None,
              max_per_class=5, seed=7, log=lines.append)
    j_fit.fit_radial_tree(cfg=json.loads(jcfg_path.read_text()), q_in=0.9, q_out=0.05, **kw)
    j_fit.fit_map_tree(cfg=json.loads(jcfg_path.read_text()), cov_type="qda", cov_structure="diag",
                       priors_mode="empirical", eps=1e-6, shrink=0.1, tau_q=0.1, **kw)
    jcfg = json.loads(jcfg_path.read_text())

    # the ✅ lines, in the reference's format, for the same species in the same order
    pat = r"✅ (\S+): rk_in=(\S+) \| rk_out=(\S+) \| rk=(\S+)"
    trk = re.findall(pat, out)
    jrk = re.findall(pat, "\n".join(lines))
    assert [r[0] for r in trk] == [r[0] for r in jrk] == SPECIES
    np.testing.assert_allclose(np.array([r[1:] for r in trk], float), np.array([r[1:] for r in jrk], float),
                               rtol=5e-4, atol=2e-5)
    # the same files picked (subsampling), the same counts, the same numbers to the latents' tolerance
    tr, jr = tcfg["radial_detector"], jcfg["radial_detector"]
    for sp in SPECIES:
        np.testing.assert_allclose(tr["centroids"][sp], jr["centroids"][sp], rtol=5e-4, atol=2e-5)
        np.testing.assert_allclose(tr["thresholds"][sp], jr["thresholds"][sp], rtol=5e-4, atol=2e-5)
        for key in ("N_in", "N_out", "used", "failed"):
            assert tr["meta_fit"]["per_species"][sp][key] == jr["meta_fit"]["per_species"][sp][key]
    assert tr["meta_fit"]["per_species"][SPECIES[0]]["N_in"] == 5
    tm, jm = tcfg["map_detector"], jcfg["map_detector"]
    assert set(tm) == set(jm) and set(tm["meta_fit"]) == set(jm["meta_fit"])
    np.testing.assert_allclose(tm["tau"], jm["tau"], rtol=1e-3, atol=1e-3)
    for sp in SPECIES:
        np.testing.assert_allclose(tm["means"][sp], jm["means"][sp], rtol=5e-4, atol=2e-5)
        np.testing.assert_allclose(tm["logdet_cov"][sp], jm["logdet_cov"][sp], rtol=1e-3, atol=1e-3)

    for wav in held:
        with pytest.raises(SystemExit) as e:
            t_eval_map.main(["--wav", str(wav), "--device", "cpu", *MEL_ARGS])
        det, _, _ = j_detect_map(wav, js, root / "config.json")
        assert e.value.code == (0 if det else 2)
    assert "MAP" in capsys.readouterr().out


def test_encode_species_tree_matches_jax_and_caches(project, tmp_path):
    root, _ = project
    ts = EncoderSession(mel=MelConfig(**SMALL), device="cpu", backend="matmul", project_root=root,
                        batch_size=4).load()
    logs = []
    Z_by, failed, used = encode_species_tree(ts, root / "chunks", SPECIES + ["Pleurodema_thaul"], cache=True,
                                             cache_dir=tmp_path, max_per_class=4, seed=3, log=logs.append)
    jZ, jfailed, jused = j_encode_tree(_jsession(root), root / "chunks", SPECIES + ["Pleurodema_thaul"],
                                       max_per_class=4, seed=3, log=lambda *_: None)
    assert list(Z_by) == list(jZ) == SPECIES and failed == jfailed and used == jused
    for sp in SPECIES:
        np.testing.assert_allclose(Z_by[sp], jZ[sp], rtol=5e-4, atol=2e-5)
    archive = np.load(tmp_path / f"Z_chunks_{SPECIES[0]}.npz")
    assert set(archive.files) == {"Z", "failed", "root", "mel_fp", "sub", "files"}
    assert str(archive["mel_fp"]).endswith("_a" + str(archive["mel_fp"]).split("_a")[-1])
    assert "_torch-matmul_" in str(archive["mel_fp"]) and str(archive["sub"]) == "4:3"
    again, _, _ = encode_species_tree(ts, root / "chunks", SPECIES, cache=True, cache_dir=tmp_path,
                                      max_per_class=4, seed=3, log=logs.append)
    assert sum("🧊" in line for line in logs) == len(SPECIES)
    assert all(np.array_equal(again[sp], Z_by[sp]) for sp in SPECIES)
    # another subsampling request is another archive identity
    encode_species_tree(ts, root / "chunks", SPECIES[:1], cache=True, cache_dir=tmp_path, max_per_class=3, seed=3,
                        log=logs.append)
    assert "♻️" in logs[-3]
    Z, idx = concat_species_latents(Z_by, SPECIES)
    jZc, jidx = j_concat(jZ, SPECIES)
    assert np.array_equal(idx, jidx) and Z.shape == jZc.shape


def test_config_resolves_against_the_project_root(project, monkeypatch, capsys):
    """Run from a subdirectory, both packages' evaluate-wav find the project's
    config.json and its default encoder artifact, and decide alike."""
    root, held = project
    sub = root / "chunks" / SPECIES[0]
    monkeypatch.chdir(sub)
    cfg = json.loads((root / "config.json").read_text())
    if "radial_detector" not in cfg:
        t_fit_radial_cli.main(["--root", "chunks", "--device", "cpu", *MEL_ARGS])
    for wav in held[:3]:
        with pytest.raises(SystemExit) as et:
            t_eval.main(["--wav", str(wav), "--config", "config.json", "--device", "cpu",
                         "--frontend-backend", "matmul", *MEL_ARGS])
        t_out = capsys.readouterr().out
        monkeypatch.setattr(sys, "argv", ["evaluate_wav", "--wav", str(wav), "--config", "config.json", *MEL_ARGS])
        with pytest.raises(SystemExit) as ej:
            j_eval.main()
        j_out = capsys.readouterr().out
        assert et.value.code == ej.value.code and t_out.split("|")[0] == j_out.split("|")[0]
    monkeypatch.chdir(root.parent)
    with pytest.raises(SystemExit, match="config.json not found"):
        t_eval.main(["--wav", str(held[0]), "--config", "config.json", "--device", "cpu"])
