"""The port's evaluation path held against the JAX package on the CPU: the
calibration sweeps (``radial_qgrid``, ``map_tau_sweep``), the benchmark and
grid writers (byte for byte), the folder benchmarks, the SNR sweep, the q_out
grid with its device sweep and Spearman analysis, the τ sweep, encode-wav,
normalize, the ``python -m anuraxla_torch`` dispatcher, and the rule that
every new entry point needs a card unless ``--device cpu``.

Tolerances are the existing ones: f32 with the same arithmetic rtol 1e-6
(thresholds, rk) and 1e-5 (taus from the same scores); latents from the two
packages' frontends rtol 5e-4 / atol 2e-5 (``tests/test_torch_fit.py``), and
the MAP scores and taus computed from them the MAP fit's rtol 1e-3 / atol
1e-3; decisions, rates, summaries and tables identical."""

import contextlib
import csv
import io
import json
import math
import shutil
import sys
import types
from datetime import datetime as real_datetime
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anuraxla.cli import calibrate_tau as j_calibrate_tau
from anuraxla.cli import encode_wav as j_encode_wav
from anuraxla.cli import normalize as j_normalize
from anuraxla.cli import run_qout_grid as j_grid
from anuraxla.cli import snapshot_from_log as j_snapshot
from anuraxla.cli import spearman_analysis as j_spearman
from anuraxla.constants import MelConfig as JMel
from anuraxla.detect import calibrate as j_cal
from anuraxla.detect import gaussian_map as j_map
from anuraxla.detect import radial as j_radial
from anuraxla.models.checkpoint import save_encoder as j_save_encoder
from anuraxla.models.vae import VAEConfig as JVAEConfig
from anuraxla.models.vae import init_encoder as j_init_encoder
from anuraxla.pipeline import benchmark as j_bench
from anuraxla.pipeline import fit as j_fit
from anuraxla.pipeline.session import EncoderSession as JSession
from anuraxla_torch import __main__ as t_dispatch
from anuraxla_torch.cli import ALIASES, COMMANDS
from anuraxla_torch.cli import benchmark_folder as t_bench_cli
from anuraxla_torch.cli import benchmark_folder_map as t_bench_map_cli
from anuraxla_torch.cli import calibrate_tau as t_calibrate_tau
from anuraxla_torch.cli import encode_wav as t_encode_wav
from anuraxla_torch.cli import normalize as t_normalize
from anuraxla_torch.cli import run_qout_grid as t_grid
from anuraxla_torch.cli import scan_soundscape as t_scan
from anuraxla_torch.cli import snapshot_from_log as t_snapshot
from anuraxla_torch.cli import spearman_analysis as t_spearman
from anuraxla_torch.detect import calibrate as t_cal
from anuraxla_torch.detect import gaussian_map as t_map
from anuraxla_torch.detect import radial as t_radial
from anuraxla_torch.pipeline import benchmark as t_bench
from anuraxla_torch.utils.wavio import write_wav

SPECIES = ["Batrachyla_leptopus", "Batrachyla_taeniata", "Calyptocephalella_gayi", "Pleurodema_thaul"]
SMALL = dict(sr=16000, duration=0.5, n_mels=32, fmin=100.0, fmax=7500.0, hop_length=128, n_fft=256,
             target_frames=48)
MEL_ARGS = ["--sr", "16000", "--n-mels", "32", "--target-frames", "48", "--fmin", "100", "--fmax", "7500",
            "--hop-length", "128", "--n-fft", "256"]
NARROW = dict(latent_dim=8, widths=(8, 16), dense_width=32, groups=4, input_hw=(48, 32))
CPU = ["--device", "cpu", "--frontend-backend", "matmul", "--batch-size", "8", *MEL_ARGS]
LATENT_TOL = dict(rtol=5e-4, atol=2e-5)
MAP_TOL = dict(rtol=1e-3, atol=1e-3)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _clusters(seed, K=4, D=16, ns=(30, 22, 17, 26), B=60, spread=1.1):
    """Padded [K, Nmax, D] train latents around K centres, and B eval
    latents with labels, drawn wider so the grid's rates move. B is no power
    of two, so a rate's last bit shows how it was divided."""
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((K, D)).astype(np.float32) * 2
    Nmax = max(ns)
    Z = np.zeros((K, Nmax, D), np.float32)
    mask = np.zeros((K, Nmax), bool)
    for k, n in enumerate(ns):
        Z[k, :n] = cent[k] + rng.standard_normal((n, D)).astype(np.float32)
        mask[k, :n] = True
    true_idx = rng.integers(0, K, B).astype(np.int32)
    Ze = (cent[true_idx] + spread * rng.standard_normal((B, D))).astype(np.float32)
    return Z, mask, Ze, true_idx


@pytest.mark.parametrize("masked", [False, True])
def test_radial_qgrid_matches_jax(masked):
    Z, mask, Ze, ti = _clusters(0)
    ranks = np.array([2, 0, 3, 1], np.float32)
    qi, qo = [0.5, 0.8, 0.9, 0.95], [0.01, 0.05, 0.1, 0.2, 0.25]
    valid = (np.arange(Ze.shape[0]) < 47) if masked else None
    fit = t_radial.fit_radial(_t(Z), _t(mask), 0.95, 0.1)
    jfit = j_radial.fit_radial(jnp.asarray(Z), jnp.asarray(mask), 0.95, 0.1)
    got = t_cal.radial_qgrid(fit, _t(Ze), _t(ti), _t(ranks), qi, qo, None if valid is None else _t(valid))
    want = j_cal.radial_qgrid(jfit, jnp.asarray(Ze), jnp.asarray(ti), jnp.asarray(ranks), np.float32(qi),
                              np.float32(qo), None if valid is None else jnp.asarray(valid))
    for name in ("accuracy", "no_detect_rate", "acc_per_class", "no_detect_per_class"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name
    for name in ("thresholds", "rk_in", "rk_out"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-6)
    acc = got.accuracy.numpy()
    assert got.thresholds.shape == (4, 5, 4) and len(np.unique(acc)) > 3  # the grid's points differ
    # each grid point is radial_decide at that point's thresholds
    i, j = 2, 3
    det, win, _ = t_radial.radial_decide(_t(Ze), fit.centroids, got.thresholds[i, j], _t(ranks))
    correct = (det & (win == _t(ti))).numpy()
    if valid is None:  # count times the f32 reciprocal of the batch, as XLA computes jnp.mean
        assert acc[i, j] == np.float32(correct.sum()) * np.float32(1 / len(ti))
    else:
        assert acc[i, j] == np.float32(correct[valid].sum()) / np.float32(valid.sum())
    # a species alone: no out-of-class pool, rk_out = inf
    solo = t_radial.fit_radial(_t(Z[:1]), _t(mask[:1]), 0.95, 0.1)
    assert torch.isinf(t_cal.radial_qgrid(solo, _t(Ze), _t(np.zeros_like(ti)), _t(ranks[:1]), qi, qo).rk_out).all()


def test_map_tau_sweep_matches_jax():
    Z, mask, Ze, ti = _clusters(1)
    qs = [0.001, 0.01, 0.05, 0.1, 0.2, 0.5]
    for kw in (dict(cov_type="lda"), dict(cov_type="qda", cov_structure="diag", shrink=0.1)):
        fit = t_map.fit_map(_t(Z), _t(mask), **kw)
        jfit = j_map.fit_map(jnp.asarray(Z), jnp.asarray(mask), **kw)
        # the same fit on both sides, so only the sweep is compared
        args = [fit.scores_true_sorted, fit.n_scores, _t(Ze), _t(ti), fit.means, fit.precisions, fit.logdets,
                fit.priors]
        taus, acc, nod = t_cal.map_tau_sweep(*args, qs)
        jt, ja, jn = j_cal.map_tau_sweep(*(jnp.asarray(a.numpy()) for a in args), np.float32(qs))
        np.testing.assert_allclose(taus.numpy(), np.asarray(jt), rtol=1e-5)
        assert np.array_equal(acc.numpy(), np.asarray(ja)) and np.array_equal(nod.numpy(), np.asarray(jn))
        assert len(np.unique(acc.numpy())) > 2 and nod.numpy()[0] < nod.numpy()[-1]


def _rows(seed, n=40, error=False, score_col="best_distance"):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        true = SPECIES[i % 3]
        pred = rng.choice(SPECIES[:3] + ["NO_DETECT"])
        rows.append({"file": f"/d/{true}/c{i}.wav", "true_species": true, "pred_species": str(pred),
                     "detected": pred != "NO_DETECT", "correct": pred == true, score_col: float(rng.random())})
    if error:
        rows.insert(3, {"file": "/d/x.wav", "true_species": SPECIES[0], "pred_species": "ERROR", "detected": False,
                        "correct": False, score_col: float("nan"), "error": "ValueError: truncated"})
    return rows


@pytest.mark.parametrize("map_variant", [False, True])
def test_results_and_summary_files_are_the_references(tmp_path, map_variant):
    col = "best_score" if map_variant else "best_distance"
    for error in (False, True):
        rows = _rows(2, error=error, score_col=col)
        ok_rows = [r for r in rows if r["pred_species"] != "ERROR"]
        for mod, d in ((t_bench, tmp_path / "t"), (j_bench, tmp_path / "j")):
            d.mkdir(exist_ok=True)
            mod.write_results_csv(rows, d / "results.csv", col)
            mod.write_summary(ok_rows, d / "summary.txt", map_variant=map_variant)
        for name in ("results.csv", "summary.txt"):
            assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
        assert ("error" in (tmp_path / "t" / "results.csv").read_text().splitlines()[0]) == error
        tr, jr = t_bench.summarize_rows(rows), j_bench.summarize_rows(rows)
        assert (tr.total, tr.accuracy, tr.no_detect_rate, tr.per_class) == (jr.total, jr.accuracy, jr.no_detect_rate,
                                                                            jr.per_class)


class _FixedNow:
    @staticmethod
    def now():
        return real_datetime(2026, 1, 2, 3, 4, 5)


def test_snapshot_and_spearman_files_are_the_references(tmp_path, monkeypatch):
    """The rk lines of a fit log -> config_snapshot.json, and a grid of runs
    -> spearman_table.csv, byte for byte; a constant series is 'n/a'."""
    for mod in (t_snapshot, j_snapshot):
        monkeypatch.setattr(mod, "datetime", _FixedNow)
    grids = {}
    for tag, snap_mod, spear_mod in (("t", t_snapshot, t_spearman), ("j", j_snapshot, j_spearman)):
        grid = tmp_path / tag / "grid"
        for k, q_out in enumerate((0.10, 0.15, 0.20, 0.25)):
            d = grid / f"qout_{q_out:.2f}"
            d.mkdir(parents=True)
            lines = ["🧪 encoded", *(f"✅ {sp}: rk_in={1 + 0.1 * i:.6f} | rk_out={0.5 + 0.1 * k + 0.01 * i:.6f} | "
                                    f"rk={0.5 + 0.1 * k * (i != 2):.6f}" for i, sp in enumerate(SPECIES[:3]))]
            lines.append(f"✅ {SPECIES[3]}: rk_in=1.000000 | rk_out=nan | rk=1.000000")
            (d / "run.log").write_text("\n".join(lines) + "\n")
            snap_mod.write_snapshot(d / "run.log", d / "config_snapshot.json", 0.95, q_out)
            rows = _rows(10 + k)
            j_bench.write_summary(rows, d / "summary.txt")
        spear_mod.analyze_grid(grid, log=lambda *a: None)
        grids[tag] = grid
    for d in sorted(p.name for p in grids["t"].iterdir() if p.is_dir()):
        t_snap = (grids["t"] / d / "config_snapshot.json").read_text()
        assert t_snap == (grids["j"] / d / "config_snapshot.json").read_text().replace(str(grids["j"]),
                                                                                       str(grids["t"]))
        assert math.isnan(json.loads(t_snap)["rk_out_per_species"][SPECIES[3]])
    table = (grids["t"] / "spearman_table.csv").read_bytes()
    assert table == (grids["j"] / "spearman_table.csv").read_bytes()
    assert b"undefined: constant input" in table
    acc_g, nd_g, acc_sp, _ = t_spearman.parse_summary(grids["t"] / "qout_0.10" / "summary.txt")
    assert (acc_g, nd_g, acc_sp) == j_spearman.parse_summary(grids["t"] / "qout_0.10" / "summary.txt")[:3]


def _write_tree(root: Path, n_per: int, seed: int, truncated: bool = False):
    """root/<species>/*.wav: a tone band per species plus noise (0.5 s,
    16 kHz PCM16); optionally one truncated WAV that neither decoder reads."""
    rng = np.random.default_rng(seed)
    t = np.arange(8000) / 16000
    for k, sp in enumerate(SPECIES):
        (root / sp).mkdir(parents=True)
        for i in range(n_per):
            f = 600 + 1500 * k + 250 * rng.standard_normal()
            y = 0.3 * np.sin(2 * np.pi * f * t) * (rng.random(t.size) > 0.3) + 0.08 * rng.standard_normal(t.size)
            write_wav(root / sp / f"c{i:02d}.wav", y.astype(np.float32), 16000)
    if truncated:
        good = (root / SPECIES[0] / "c00.wav").read_bytes()
        (root / SPECIES[0] / "zz_truncated.wav").write_bytes(good[:30])


def _jsession(root, **kw):
    return JSession(mel=JMel(**SMALL), backend="matmul", project_root=root, batch_size=8, **kw).load()


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """A project root: the default encoder artifact (written by the JAX
    package), train and val trees (val with one truncated WAV), and a
    config.json with the radial and LDA MAP blocks fitted by the JAX package.
    -> (root, the JAX package's session on it, compiled once)."""
    root = tmp_path_factory.mktemp("evalproject")
    _write_tree(root / "latent_space_exploration" / "train_chunks", 12, seed=1)
    _write_tree(root / "latent_space_exploration" / "val_chunks", 10, seed=2, truncated=True)
    jcfg = JVAEConfig(**NARROW)
    _, params = j_init_encoder(jcfg, seed=5)
    j_save_encoder(root / "models" / "anuraxla_vae_encoder_v0", jcfg, params)
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps({"species": SPECIES, "chunk_seconds": 0.5}))
    js = _jsession(root)
    kw = dict(cfg_path=cfg_path, chunks_dir=root / "latent_space_exploration" / "train_chunks", session=js,
              cache=False, cache_dir=None, max_per_class=0, seed=7, log=lambda *a: None)
    j_fit.fit_radial_tree(cfg=json.loads(cfg_path.read_text()), q_in=0.9, q_out=0.1, **kw)
    j_fit.fit_map_tree(cfg=json.loads(cfg_path.read_text()), cov_type="lda", cov_structure="full",
                       priors_mode="empirical", eps=1e-6, shrink=0.0, tau_q=0.05, **kw)
    return root, js


def _copy(project, dest: Path) -> Path:
    shutil.copytree(project, dest)
    return dest


def _read_csv(path):
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("detector", ["radial", "map"])
def test_benchmark_folder_cli_matches_jax(project, tmp_path, monkeypatch, capsys, detector):
    """The port's benchmark-folder(-map) CLI on the CPU against the JAX
    package's run_folder_benchmark on the same tree, artifact and config."""
    project, js = project
    monkeypatch.chdir(project)
    val = project / "latent_space_exploration" / "val_chunks"
    cli = t_bench_cli if detector == "radial" else t_bench_map_cli
    cli.main(["--root", str(val), "--out-dir", str(tmp_path / "t"), *CPU])
    out = capsys.readouterr().out
    res = j_bench.run_folder_benchmark(root=val, config_path=project / "config.json", detector=detector,
                                       session=js, out_dir=tmp_path / "j", log=lambda *a: None)
    assert "✅ DONE" in out and (" (MAP)" in out) == (detector == "map")
    t_rows, j_rows = _read_csv(tmp_path / "t" / "results.csv"), _read_csv(tmp_path / "j" / "results.csv")
    col = "best_distance" if detector == "radial" else "best_score"
    assert [r["file"] for r in t_rows] == [r["file"] for r in j_rows]
    for key in ("true_species", "pred_species", "detected", "correct"):
        assert [r[key] for r in t_rows] == [r[key] for r in j_rows], key
    errors = [r for r in t_rows if r["pred_species"] == "ERROR"]
    assert len(errors) == 1 and errors[0]["file"].endswith("zz_truncated.wav") and errors[0]["error"]
    ok = [i for i, r in enumerate(j_rows) if r["pred_species"] != "ERROR"]
    tol = LATENT_TOL if detector == "radial" else MAP_TOL
    np.testing.assert_allclose([float(t_rows[i][col]) for i in ok], [float(j_rows[i][col]) for i in ok], **tol)
    summary = (tmp_path / "t" / "summary.txt").read_text()
    assert summary == (tmp_path / "j" / "summary.txt").read_text()
    acc, nd, acc_sp, _ = t_spearman.parse_summary(tmp_path / "t" / "summary.txt")
    assert acc == pytest.approx(res.accuracy, abs=5e-5) and 0.0 < acc < 1.0 and len(acc_sp) == len(SPECIES)
    assert f"Total files: {len(SPECIES) * 10}" in summary


def test_snr_sweep_matches_jax(project, tmp_path, monkeypatch, capsys):
    """--snr-sweep clean,14: the same curve, the same per-point summaries; the
    flag excludes --add-noise-db."""
    project, js = project
    monkeypatch.chdir(project)
    val = project / "latent_space_exploration" / "val_chunks"
    t_bench_cli.main(["--root", str(val), "--out-dir", str(tmp_path / "t"), "--snr-sweep", "clean,14", *CPU])
    j_bench.run_snr_sweep(root=val, config_path=project / "config.json", detector="radial",
                          session=js, out_dir=tmp_path / "j", snrs_db=[None, 14.0],
                          log=lambda *a: None)
    curve = (tmp_path / "t" / "snr_curve.csv").read_text()
    assert curve == (tmp_path / "j" / "snr_curve.csv").read_text()
    assert len(curve.splitlines()) == 3
    for tag in ("clean", "snr_14db"):
        assert (tmp_path / "t" / tag / "summary.txt").read_text() == (tmp_path / "j" / tag / "summary.txt").read_text()
    capsys.readouterr()
    with pytest.raises(SystemExit, match="mutually exclusive"):
        t_bench_cli.main(["--root", str(val), "--add-noise-db", "10", "--snr-sweep", "clean", *CPU])


def _jax_main(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    module.main()


def test_run_qout_grid_matches_jax(project, tmp_path, monkeypatch, capsys):
    """run-qout-grid --device-sweep --q-in-grid 0.8 0.9 --q-out-grid 0.1 0.2
    --noise-margin-db 14 --analyze, each package in a copy of the project:
    per-point artifacts, grid_metrics.csv, the operating point and the
    Spearman table."""
    project, _ = project
    argv = ["--q-out-grid", "0.1", "0.2", "--q-in", "0.9", "--device-sweep", "--q-in-grid", "0.8", "0.9",
            "--noise-margin-db", "14", "--analyze", "--max-per-class", "10", "--seed", "3"]
    roots = {}
    for tag in ("t", "j"):
        root = roots[tag] = _copy(project, tmp_path / tag)
        monkeypatch.chdir(root)
        grid = ["--grid-root", str(root / "grid")]
        if tag == "t":
            t_grid.main(argv + grid + CPU)
        else:
            _jax_main(monkeypatch, j_grid, argv + grid + ["--device", "cpu", "--frontend-backend", "matmul",
                                                          "--batch-size", "8", *MEL_ARGS])
        roots[tag + "_out"] = capsys.readouterr().out
    t_root, j_root = roots["t"], roots["j"]
    pick = [line for line in roots["t_out"].splitlines() if "noise-margin operating point" in line]
    assert len(pick) == 1 and pick == [line for line in roots["j_out"].splitlines()
                                       if "noise-margin operating point" in line]
    for q in ("qout_0.10", "qout_0.20"):
        d_t, d_j = t_root / "grid" / q, j_root / "grid" / q
        for name in ("summary.txt", "results.csv", "config_used.json", "config_snapshot.json", "run.log"):
            assert (d_t / name).exists(), (q, name)
        assert (d_t / "summary.txt").read_text() == (d_j / "summary.txt").read_text()
        st, sj = (json.loads((d / "config_snapshot.json").read_text()) for d in (d_t, d_j))
        assert sorted(st["rk_per_species"]) == sorted(SPECIES) and st["q_out"] == sj["q_out"]
        for key in ("rk_per_species", "rk_in_per_species", "rk_out_per_species"):
            np.testing.assert_allclose([st[key][sp] for sp in SPECIES], [sj[key][sp] for sp in SPECIES], **LATENT_TOL)
    gt, gj = _read_csv(t_root / "grid" / "grid_metrics.csv"), _read_csv(j_root / "grid" / "grid_metrics.csv")
    assert len(gt) == 4 and list(gt[0]) == list(gj[0])
    for rt, rj in zip(gt, gj):
        assert rt == rj  # the q columns, every rate and every per-class rate
    # at q_in = 0.9 each sweep point is the per-point benchmark's accuracy
    for r in gt:
        if float(r["q_in"]) == 0.9:
            acc = t_spearman.parse_summary(t_root / "grid" / f"qout_{float(r['q_out']):.2f}" / "summary.txt")[0]
            assert f"{float(r['val_accuracy']) * 100:.2f}" == f"{acc * 100:.2f}"
    tt, tj = _read_csv(t_root / "grid" / "spearman_table.csv"), _read_csv(j_root / "grid" / "spearman_table.csv")
    assert [(r["scope"], r["species"], r["x"], r["y"], r["n_points"], r["note"]) for r in tt] == \
           [(r["scope"], r["species"], r["x"], r["y"], r["n_points"], r["note"]) for r in tj]


def test_calibrate_tau_matches_jax(project, tmp_path, monkeypatch, capsys):
    """calibrate-tau --set-best: tau_grid.csv against the JAX package's, and
    the best τ written into config.json with a backup."""
    project, _ = project
    argv = ["--train-root", "train_chunks", "--val-root", "val_chunks", "--tau-q-grid", "0.01", "0.05", "0.1",
            "0.3", "0.6", "--set-best"]
    grids = {}
    for tag in ("t", "j"):
        root = _copy(project, tmp_path / tag)
        monkeypatch.chdir(root)
        out = ["--out", str(root / "tau_grid.csv")]
        if tag == "t":
            t_calibrate_tau.main(argv + out + CPU)
        else:
            _jax_main(monkeypatch, j_calibrate_tau, argv + out + ["--device", "cpu", "--frontend-backend", "matmul",
                                                                  "--batch-size", "8", *MEL_ARGS])
        grids[tag] = (_read_csv(root / "tau_grid.csv"), json.loads((root / "config.json").read_text()))
        assert (root / "config.json.bak").exists()
    capsys.readouterr()
    (gt, ct), (gj, cj) = grids["t"], grids["j"]
    assert [r["tau_q"] for r in gt] == [r["tau_q"] for r in gj] == ["0.01", "0.05", "0.1", "0.3", "0.6"]
    np.testing.assert_allclose([float(r["tau"]) for r in gt], [float(r["tau"]) for r in gj], **MAP_TOL)
    for key in ("val_accuracy", "val_no_detect_rate"):
        assert [r[key] for r in gt] == [r[key] for r in gj], key
    assert len({r["val_no_detect_rate"] for r in gt}) > 1
    np.testing.assert_allclose(ct["map_detector"]["tau"], cj["map_detector"]["tau"], **MAP_TOL)
    assert ct["map_detector"]["meta_fit"]["tau_from_train_quantile"] == \
        cj["map_detector"]["meta_fit"]["tau_from_train_quantile"]


def test_encode_wav_matches_jax(project, monkeypatch, capsys):
    """encode-wav --wav and --root --jsonl (with --auto-frames) against the
    JAX package's, on the project's artifact."""
    project, _ = project
    monkeypatch.chdir(project)
    val = project / "latent_space_exploration" / "val_chunks"
    wav = val / SPECIES[1] / "c03.wav"
    common = ["--duration", "0.5", "--jsonl", "--auto-frames"]
    t_mel = [a for a in CPU if a not in ("--target-frames", "48", "--n-mels", "32")]
    j_mel = ["--device", "cpu", "--frontend-backend", "matmul", "--batch-size", "8",
             *[a for a in MEL_ARGS if a not in ("--target-frames", "48", "--n-mels", "32")]]
    outs = {}
    for tag in ("t", "j"):
        for what in (["--wav", str(wav)], ["--root", str(val)]):
            if tag == "t":
                t_encode_wav.main(what + common + t_mel)
            else:
                _jax_main(monkeypatch, j_encode_wav, what + common + j_mel)
            outs[tag, what[0]] = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    for what in ("--wav", "--root"):
        t, j = outs["t", what], outs["j", what]
        assert [(r["index"], r["file"], r["label"], r["dim"]) for r in t] == \
               [(r["index"], r["file"], r["label"], r["dim"]) for r in j]
        np.testing.assert_allclose([r["vector"] for r in t], [r["vector"] for r in j], rtol=5e-4, atol=2e-5)
    assert len(outs["t", "--root"]) == len(SPECIES) * 10 and outs["t", "--wav"][0]["dim"] == NARROW["latent_dim"]


def test_normalize_matches_jax(tmp_path):
    """normalize's process_split: the same files as the JAX package's, within
    one PCM16 step (the two RMS scales differ in the last bit at most)."""
    src = tmp_path / "src"
    _write_tree(src, 3, seed=4)
    rng = np.random.default_rng(5)
    write_wav(src / SPECIES[0] / "long.wav", (0.2 * rng.standard_normal(12000)).astype(np.float32), 16000)
    write_wav(src / SPECIES[1] / "quiet.wav", (1e-5 * rng.standard_normal(8000)).astype(np.float32), 16000)
    logs = []
    n_t = t_normalize.process_split(src, tmp_path / "t", 16000, 4, log=logs.append, device="cpu")
    n_j = j_normalize.process_split(src, tmp_path / "j", 16000, 4, log=lambda *a: None)
    assert n_t == n_j == 3 * len(SPECIES) + 2
    from anuraxla_torch.utils.wavio import read_wav

    for f in sorted((tmp_path / "j").rglob("*.wav")):
        a, _ = read_wav(tmp_path / "t" / f.relative_to(tmp_path / "j"))
        b, _ = read_wav(f)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1 / 32768
    quiet, _ = read_wav(tmp_path / "t" / SPECIES[1] / "quiet.wav")
    assert np.abs(quiet).max() < 1e-3  # below the silence gate: copied unscaled


def test_dispatcher_lists_commands_and_resolves_aliases(monkeypatch, capsys):
    with pytest.raises(SystemExit) as e:
        t_dispatch.main(["--help"])
    out = capsys.readouterr().out
    assert e.value.code == 0 and all(f"  {name}\n" in out for name in COMMANDS)
    assert set(ALIASES.values()) <= set(COMMANDS)
    new = {"benchmark-folder", "benchmark-folder-map", "calibrate-tau", "run-qout-grid", "scan-soundscape",
           "encode-wav", "normalize", "snapshot-from-log", "spearman-analysis",
           "train-vae", "print-latents", "make-synth-data", "ingest-encoder", "ingest-decoder"}
    assert new | {"fit-radial", "fit-map", "evaluate-wav", "evaluate-wav-map", "bench"} == set(COMMANDS)
    for alias, cmd in (("10", "benchmark-folder"), ("10b", "benchmark-folder-map"), ("9200", "run-qout-grid"),
                       ("9100", "spearman-analysis"), ("9105", "snapshot-from-log"), ("00", "normalize")):
        assert ALIASES[alias] == cmd
        with pytest.raises(SystemExit) as e:
            t_dispatch.main([alias, "--help"])
        assert e.value.code == 0 and f"anuraxla_torch {cmd}" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown command"):
        t_dispatch.main(["no-such-command"])
    with pytest.raises(SystemExit) as e:
        t_dispatch.main([])
    assert e.value.code == 1
    capsys.readouterr()


@pytest.mark.parametrize("cli,argv", [
    (t_bench_cli, ["--root", "latent_space_exploration/val_chunks"]),
    (t_bench_map_cli, ["--root", "latent_space_exploration/val_chunks"]),
    (t_calibrate_tau, []),
    (t_grid, ["--q-out-grid", "0.1"]),
    (t_scan, ["--root", "latent_space_exploration/val_chunks"]),
    (t_encode_wav, ["--root", "latent_space_exploration/val_chunks"]),
    (t_normalize, []),
], ids=lambda v: v.__name__.rsplit(".", 1)[-1] if hasattr(v, "__name__") else "")
def test_new_entry_points_need_a_card_or_cpu(project, tmp_path, monkeypatch, capsys, cli, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.chdir(_copy(project[0], tmp_path / "p"))
    with pytest.raises(RuntimeError, match="device='cuda'"):
        cli.main(argv)
    capsys.readouterr()


def test_subprocess_compat_forwards_every_result_changing_flag():
    """The flags --subprocess-compat forwards: every result-changing one of
    add_mel_args / add_batch_args, the tier's knobs resolved, the boolean
    flags only when on."""
    args = t_grid.build_parser().parse_args([
        "--fast-frontend", "--frontend-backend", "cuda-bf16", "--transfer-int16", "--pre-padded-host",
        "--quantize-serving", "--encoder", "enc_dir", "--batch-size", "128", "--device", "cpu",
    ])
    shared = t_grid.subprocess_shared_args(args, "cfg.json")
    for flag in ("--fast-frontend", "--transfer-int16", "--pre-padded-host", "--quantize-serving",
                 "--frontend-backend", "--encoder-dtype",
                 "--encoder", "--sr", "--n-mels", "--target-frames", "--fmin", "--fmax", "--hop-length", "--n-fft",
                 "--batch-size", "--io-threads", "--device", "--config"):
        assert flag in shared, flag
    assert shared[shared.index("--frontend-backend") + 1] == "cuda-bf16"
    assert shared[shared.index("--device") + 1] == "cpu"
    tier = t_grid.subprocess_shared_args(t_grid.build_parser().parse_args(["--serving-tier", "fast"]), "c.json")
    assert tier[tier.index("--encoder-dtype") + 1] == "bfloat16" and "--fast-frontend" in tier
    assert tier[tier.index("--frontend-backend") + 1] == "cuda-bf16"
    off = t_grid.subprocess_shared_args(t_grid.build_parser().parse_args([]), "c.json")
    assert not {"--fast-frontend", "--transfer-int16", "--pre-padded-host", "--quantize-serving"} & set(off)
    assert off[off.index("--device") + 1] == "cuda"


def test_run_qout_grid_subprocess_compat_matches_in_process(project, tmp_path, monkeypatch, capsys):
    """--subprocess-compat runs ``python -m anuraxla_torch fit-radial`` and
    ``benchmark-folder`` for a grid point, with the repo on PYTHONPATH: the
    command lines go through the dispatcher (in this process, to spare two
    interpreter starts) and give the in-process grid's artifacts."""
    project, _ = project
    repo = Path(t_grid.__file__).resolve().parents[2]
    spawned = []

    def run_in_process(cmd, stdout, stderr, text, env):
        assert cmd[:3] == [sys.executable, "-m", "anuraxla_torch"] and env["PYTHONPATH"].split(":")[0] == str(repo)
        spawned.append(cmd[3])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            t_dispatch.main(cmd[3:])
        return types.SimpleNamespace(stdout=buf.getvalue(), returncode=0)

    monkeypatch.setattr(t_grid.subprocess, "run", run_in_process)
    monkeypatch.setattr(sys, "argv", list(sys.argv))  # the dispatcher rewrites it
    argv = ["--q-out-grid", "0.2", "--max-per-class", "10", "--seed", "3", *CPU]
    for tag, extra in (("inproc", []), ("spawned", ["--subprocess-compat"])):
        root = _copy(project, tmp_path / tag)
        monkeypatch.chdir(root)
        t_grid.main(argv + extra + ["--grid-root", str(root / "grid")])
    assert spawned == ["fit-radial", "benchmark-folder"] and "✅ DONE" in capsys.readouterr().out
    a, b = tmp_path / "inproc" / "grid" / "qout_0.20", tmp_path / "spawned" / "grid" / "qout_0.20"
    assert (a / "summary.txt").read_text() == (b / "summary.txt").read_text()
    assert "rk_in=" in (b / "run.log").read_text()  # the children's output is the point's log
    sa, sb = (json.loads((d / "config_snapshot.json").read_text()) for d in (a, b))
    assert sa["rk_per_species"] == sb["rk_per_species"] and len(sa["rk_per_species"]) == len(SPECIES)
    ra, rb = _read_csv(a / "results.csv"), _read_csv(b / "results.csv")
    assert [r["pred_species"] for r in ra] == [r["pred_species"] for r in rb]
