"""The port's pipeline driver and measurement drives (``anuraxla_torch/scripts/``)
held against the JAX package on the CPU.

- The driver end to end: ``run_full_pipeline.sh`` as a subprocess on a
  ``make-synth-data --per-species 2`` tree at ``DEFAULT_MEL`` (the scripts
  take no mel flags) with a small encoder artifact written by the JAX
  package's ``save_encoder`` (so step 02 is skipped), ``DEVICE_DEFAULT=cpu``.
  Its outputs are held, in process, against the JAX package's ``fit-map`` on
  the same ``_norm`` train tree with the same artifact and flags, its
  ``encode-wav --jsonl`` on the val split and its ``benchmark-folder-map`` on
  the test split (the split the driver benchmarks). The JAX CLIs default to
  the ``matmul`` frontend and the port's to its kernel, on the CPU the
  kernel's plain version: they differ within the frontend's 1e-4
  (test_pallas_frontend.py:153). MAP means are held to 1e-4 of their largest
  component (measured <= 9.6e-7), logdets and tau to rtol 1e-4 (measured
  <= 8.3e-7), best scores to rtol 1e-4 (measured <= 5.0e-6), latents to rtol
  5e-4 / atol 2e-5 (measured <= 2.0e-6: the JSONL's six decimals),
  decisions identical.
- The training branch: ``02_train_vae.sh`` alone for one step at a tiny
  config passed through its ``"$@"`` (16 kHz mel flags, ``--init-from`` a
  narrow artifact); the artifact loads in both packages.
- No fallback: ``DEVICE_DEFAULT`` unset or ``auto`` fails step 01 with
  ``resolve_device``'s message on a host with no card.
- The two diagnostics the reference's drives ran inline, against that inline
  code: ``decision_diff`` prints what ``scripts/drive_fast_tier.sh``'s heredoc
  prints, byte for byte; ``noise_distance``'s table holds the numbers the
  heredoc of ``scripts/drive_5db_floor.sh`` computes in process from the JAX
  package within 2e-2 of each value (measured <= 9.1e-3: both run a bf16
  encoder trunk, whose convolutions the two packages round apart).
- Both drivers speak the same commands: each ``$ANURAXLA <command> ...`` line
  of the port's scripts, its shell variables replaced by sample values,
  parses under the port's parser for that command, the matching
  ``python -m anuraxla ...`` line of ``scripts/`` under the JAX parser, and
  the two argument lists differ only in ``--device`` and in
  ``--frontend-backend cuda`` for the reference's ``pallas``.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import importlib
import io
import json
import os
import re
import shlex
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from anuraxla.cli import benchmark_folder_map as j_bench_map
from anuraxla.cli import encode_wav as j_encode_wav
from anuraxla.cli import fit_map as j_fit_map
from anuraxla.cli.make_synth_data import make_tree as j_make_tree
from anuraxla.models import checkpoint as j_ckpt
from anuraxla.models.vae import VAEConfig as JVAEConfig
from anuraxla.models.vae import init_encoder as j_init_encoder
from anuraxla_torch.cli import make_synth_data as t_synth
from anuraxla_torch.config import load_config, priority_ranks, read_radial
from anuraxla_torch.constants import SPECIES
from anuraxla_torch.detect.radial import radial_decide
from anuraxla_torch.models import checkpoint as t_ckpt
from anuraxla_torch.models.vae import ConvVAEEncoder
from anuraxla_torch.scripts import decision_diff, noise_distance

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "anuraxla_torch" / "scripts"
JSCRIPTS = REPO / "scripts"
TINY = JVAEConfig(input_hw=(192, 64), widths=(8, 16), latent_dim=24, dense_width=32, groups=4)
N_PER = 2  # WAVs of each species and split
GRID = ("0.10", "0.20")
# the driver's variables that the tests set; the caller's own are dropped
DRIVER_VARS = ("DEVICE_DEFAULT", "TRAIN_DEVICE", "QOUT_GRID", "MAX_PER_CLASS_DEFAULT", "TRAIN_STEPS", "TRAIN_BATCH",
               "PROJECT_ROOT", "CHUNKS_ROOT", "TRAIN_CHUNKS", "VAL_CHUNKS", "TEST_CHUNKS", "MODELS_DIR",
               "OUTPUTS_DIR", "ENCODER_DIR", "CONFIG_JSON", "GRID_ROOT", "MAP_FIT_ARGS")
LATENT_TOL = dict(rtol=5e-4, atol=2e-5)


@pytest.fixture(scope="module")
def script_env(tmp_path_factory):
    """-> ``env(**kw)``: the environment of the scripts' processes, the
    caller's without the driver's variables, plus ``kw``. The processes share
    one bytecode cache (this host's Python is set to write none, and each
    process would compile every module it imports anew), each takes two
    intra-op threads (the suite runs several workers; more threads would
    spin against theirs), and matplotlib is hidden from them, as on the
    card's machine, which has none: the benchmarks' plots are best-effort and
    cost seconds each here."""
    pyc = tmp_path_factory.mktemp("pycache")
    hide = tmp_path_factory.mktemp("no_matplotlib")
    (hide / "matplotlib").mkdir()
    (hide / "matplotlib" / "__init__.py").write_text('raise ImportError("matplotlib is hidden from this run")\n')
    base = {k: v for k, v in os.environ.items() if k not in DRIVER_VARS and k != "PYTHONDONTWRITEBYTECODE"}
    base.update(PYTHONPYCACHEPREFIX=str(pyc), OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(filter(None, [str(hide),
                                                                                     base.get("PYTHONPATH")])))

    def env(**kw) -> dict:
        return {**base, **kw}

    return env


def _bash(script: str, cwd: Path, env: dict, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run(["bash", str(SCRIPTS / script), *args], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)


def _tail(r: subprocess.CompletedProcess) -> str:
    return f"rc {r.returncode}\n--- stdout\n{r.stdout[-3000:]}\n--- stderr\n{r.stderr[-3000:]}"


@pytest.fixture(scope="module")
def driven(tmp_path_factory, script_env):
    """A project the port's driver has run through: -> (project, the run)."""
    proj = tmp_path_factory.mktemp("project")
    with contextlib.redirect_stdout(io.StringIO()):
        t_synth.main(["--root", str(proj / "latent_space_exploration"), "--per-species", str(N_PER), "--seed", "0"])
    _, params = j_init_encoder(TINY, seed=7)
    j_ckpt.save_encoder(proj / "models" / "anuraxla_vae_encoder_v0", TINY, params)
    r = _bash("run_full_pipeline.sh", proj, script_env(DEVICE_DEFAULT="cpu", QOUT_GRID=" ".join(GRID),
                                                        MAX_PER_CLASS_DEFAULT=str(N_PER)))
    return proj, r


def _run_jax(module, argv, cwd: Path) -> str:
    """A JAX CLI's ``main`` in process (the ``run_cli`` pattern of
    test_pipeline_e2e.py) -> its standard output; exit 0 required."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        mp.setattr(sys, "argv", ["prog", *argv])
        with contextlib.redirect_stdout(buf):
            try:
                module.main()
            except SystemExit as e:
                assert e.code in (None, 0), (module.__name__, e.code, buf.getvalue()[-2000:])
    return buf.getvalue()


@pytest.fixture(scope="module")
def jax_runs(driven):
    """The JAX package's fit-map, encode-wav and benchmark-folder-map on the
    driver's ``_norm`` trees, with the same artifact and flags, in a project
    of its own -> (its project, the val JSONL it printed)."""
    proj, r = driven
    assert r.returncode == 0, _tail(r)
    jproj = proj.parent / "jax_project"
    jproj.mkdir()
    (jproj / "config.json").write_text(json.dumps({"species": list(SPECIES), "chunk_seconds": 5.0}, indent=2))
    shutil.copytree(proj / "models", jproj / "models")
    lse = proj / "latent_space_exploration"
    cfg = str(jproj / "config.json")
    _run_jax(j_fit_map, ["--config", cfg, "--root", str(lse / "train_chunks_norm"), "--max-per-class", str(N_PER),
                         "--cache", "--set-tau-q", "0.01", "--preset", "small-n"], jproj)
    jsonl = _run_jax(j_encode_wav, ["--root", str(lse / "val_chunks_norm"), "--jsonl", "--duration", "5.0"], jproj)
    _run_jax(j_bench_map, ["--root", str(lse / "test_chunks_norm"), "--config", cfg], jproj)
    return jproj, jsonl


def _jsonl(text: str) -> dict:
    return {r["file"]: r for r in map(json.loads, text.strip().splitlines())}


def _results(path: Path) -> dict:
    with open(path) as f:
        return {r["file"]: r for r in csv.DictReader(f)}


def test_driver_leaves_every_artifact(driven):
    proj, r = driven
    assert r.returncode == 0, _tail(r)
    assert "✅ preflight ok" in r.stdout and "encoder artifact present, skipping training" in r.stdout
    assert "🏁 full pipeline done" in r.stdout
    cfg = json.loads((proj / "config.json").read_text())
    assert cfg["chunk_seconds"] == 5.0 and set(cfg["radial_detector"]["centroids"]) == set(SPECIES)
    assert cfg["map_detector"]["cov_structure"] == "diag" and cfg["map_detector"]["tau"] is not None
    lse, out = proj / "latent_space_exploration", proj / "outputs"
    for split in ("train", "val", "test"):
        wavs = sorted((lse / f"{split}_chunks_norm").rglob("*.wav"))
        assert len(wavs) == len(SPECIES) * N_PER
        rows = _jsonl((out / "latents" / f"{split}_latents.jsonl").read_text())
        assert sorted(rows) == [str(w) for w in wavs] and all(r["dim"] == TINY.latent_dim for r in rows.values())
    (grid,) = sorted(out.glob("qout_grid_*"))
    for q in GRID:
        for f in ("run.log", "summary.txt", "results.csv", "config_used.json", "config_snapshot.json"):
            assert (grid / f"qout_{q}" / f).is_file(), (q, f)
    assert (grid / "spearman_table.csv").is_file()
    for bench in ("detection_benchmark", "detection_benchmark_map"):
        assert len(_results(out / bench / "results.csv")) == len(SPECIES) * N_PER
        assert (out / bench / "summary.txt").is_file()


def test_driver_caches_name_the_arithmetic(driven):
    """The species-tree caches of fit-map and the grid carry the arithmetic
    that ran: on the CPU the kernel's plain version."""
    proj, _ = driven
    caches = sorted((proj / "cache_npz").glob("Z_train_chunks_norm_*.npz"))
    assert len(caches) == len(SPECIES)
    for c in caches:
        fp = str(np.load(c)["mel_fp"])
        assert "_torch-cuda-cpuplain_" in fp, (c.name, fp)


def test_radial_benchmark_decisions_from_the_latents(driven):
    """benchmark-folder's decisions equal ``radial_decide`` from the test
    latents of the driver's JSONL and its final config.json."""
    proj, _ = driven
    rows = _results(proj / "outputs" / "detection_benchmark" / "results.csv")
    lat = _jsonl((proj / "outputs" / "latents" / "test_latents.jsonl").read_text())
    species, cents, thr, _ = read_radial(load_config(proj / "config.json"))
    files = sorted(rows)
    Z = torch.tensor([lat[f]["vector"] for f in files], dtype=torch.float32)
    detected, winner, best = radial_decide(Z, *(torch.from_numpy(a) for a in (cents, thr, priority_ranks(species))))
    for i, f in enumerate(files):
        pred = species[int(winner[i])] if bool(detected[i]) else "NO_DETECT"
        assert (rows[f]["pred_species"], rows[f]["detected"]) == (pred, str(bool(detected[i]))), f
        # the JSONL rounds to six decimals
        np.testing.assert_allclose(float(rows[f]["best_distance"]), float(best[i]), rtol=1e-4, atol=1e-5)


def test_fit_map_matches_jax(driven, jax_runs):
    proj, _ = driven
    jproj, _ = jax_runs
    got = json.loads((proj / "config.json").read_text())["map_detector"]
    want = json.loads((jproj / "config.json").read_text())["map_detector"]
    for key in ("model", "cov_type", "cov_structure", "priors"):
        assert got[key] == want[key]
    assert got["meta_fit"]["shrink"] == want["meta_fit"]["shrink"] == 0.1
    for sp in SPECIES:
        g, w = np.asarray(got["means"][sp]), np.asarray(want["means"][sp])
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), sp
        np.testing.assert_allclose(got["logdet_cov"][sp], want["logdet_cov"][sp], rtol=1e-4)
        np.testing.assert_allclose(np.asarray(got["precision"][sp]), np.asarray(want["precision"][sp]), rtol=1e-4)
    np.testing.assert_allclose(got["tau"], want["tau"], rtol=1e-4)


def test_val_latents_match_jax(driven, jax_runs):
    proj, _ = driven
    _, jsonl = jax_runs
    got = _jsonl((proj / "outputs" / "latents" / "val_latents.jsonl").read_text())
    want = _jsonl(jsonl)
    assert sorted(got) == sorted(want) and len(got) == len(SPECIES) * N_PER
    for f in got:
        assert (got[f]["index"], got[f]["label"], got[f]["dim"]) == (want[f]["index"], want[f]["label"],
                                                                     want[f]["dim"])
        np.testing.assert_allclose(got[f]["vector"], want[f]["vector"], **LATENT_TOL)


def test_map_benchmark_matches_jax(driven, jax_runs):
    proj, _ = driven
    jproj, _ = jax_runs
    got = _results(proj / "outputs" / "detection_benchmark_map" / "results.csv")
    want = _results(jproj / "outputs" / "detection_benchmark_map" / "results.csv")
    assert sorted(got) == sorted(want)
    for f in got:
        assert [got[f][k] for k in ("true_species", "pred_species", "detected", "correct")] == \
            [want[f][k] for k in ("true_species", "pred_species", "detected", "correct")], f
        np.testing.assert_allclose(float(got[f]["best_score"]), float(want[f]["best_score"]), rtol=1e-4)
    assert (proj / "outputs" / "detection_benchmark_map" / "summary.txt").read_text() == \
        (jproj / "outputs" / "detection_benchmark_map" / "summary.txt").read_text()


MEL_ARGS = ["--sr", "16000", "--n-mels", "32", "--target-frames", "48", "--fmin", "100", "--fmax", "7500",
            "--hop-length", "128", "--n-fft", "256"]
NARROW = JVAEConfig(latent_dim=8, widths=(8, 16), dense_width=32, groups=4, input_hw=(48, 32))


def test_train_branch_artifact_loads_in_both_packages(tmp_path, script_env):
    """``02_train_vae.sh`` alone for one step, with a tiny config passed
    through its ``"$@"``: the 16 kHz mel flags of a 16 kHz tree and a narrow
    JAX artifact to start from (``--init-from``: its architecture is the
    trained one). The artifact written at ``$ENCODER_DIR`` gives the same mu
    in both packages."""
    j_make_tree(tmp_path / "data", sr=16000, seconds=5.0, per_species=N_PER, splits=("train_chunks",), seed=3)
    (tmp_path / "models").mkdir()
    (tmp_path / "config.json").write_text(json.dumps({"chunk_seconds": 5.0}))
    _, init = j_init_encoder(NARROW, seed=5)
    j_ckpt.save_encoder(tmp_path / "init", NARROW, init)
    r = _bash("02_train_vae.sh", tmp_path,
              script_env(DEVICE_DEFAULT="cpu", TRAIN_STEPS="1", TRAIN_BATCH="8",
                   TRAIN_CHUNKS=str(tmp_path / "data" / "train_chunks")),
              *MEL_ARGS, "--init-from", str(tmp_path / "init"), "--kl-delay", "1", "--kl-warmup", "1")
    assert r.returncode == 0, _tail(r)
    assert re.search(r"🏁 1 steps in .* examples/s", r.stdout)
    art = tmp_path / "models" / "anuraxla_vae_encoder_v0"
    state, cfg = t_ckpt.load_encoder(art)
    assert (tuple(cfg.input_hw), tuple(cfg.widths), cfg.latent_dim) == ((48, 32), (8, 16), 8)
    enc, params, jcfg = j_ckpt.load_encoder(art)
    assert jcfg == NARROW
    x = jax.numpy.asarray(np.random.default_rng(0).standard_normal((3, 48, 32, 1)).astype(np.float32))
    want = np.asarray(enc.apply(params, x)["mu"])
    model = ConvVAEEncoder(cfg)
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.from_numpy(np.array(x)))["mu"].numpy()
    np.testing.assert_allclose(got, want, **LATENT_TOL)


@pytest.mark.parametrize("script,device", [("01_normalize_chunks.sh", None), ("01_normalize_chunks.sh", "auto"),
                                           ("run_full_pipeline.sh", None)],
                         ids=["step01-unset", "step01-auto", "driver-unset"])
def test_no_fallback_without_a_card(tmp_path, script_env, script, device):
    """``DEVICE_DEFAULT`` unset names the card, ``auto`` is no device of the
    port: on a host with no card step 01 fails with ``resolve_device``'s
    message and writes nothing, and the driver stops there."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with contextlib.redirect_stdout(io.StringIO()):
        t_synth.main(["--root", str(tmp_path / "latent_space_exploration"), "--sr", "16000", "--seconds", "0.5",
                      "--per-species", "1"])
    r = _bash(script, tmp_path, script_env(**({"DEVICE_DEFAULT": device} if device else {})))
    assert r.returncode != 0, _tail(r)
    want = "device='auto': the port runs on 'cuda'" if device else "device='cuda' requested but"
    assert want in r.stderr, _tail(r)
    assert not (tmp_path / "latent_space_exploration" / "train_chunks_norm").exists()
    if script == "run_full_pipeline.sh":
        assert "✅ preflight ok" in r.stdout and "full pipeline done" not in r.stdout
        assert not (tmp_path / "outputs").exists()


def _heredoc(script: Path) -> str:
    """The inline Python of a reference drive (``python - <<'EOF' ... EOF``)."""
    (code,) = re.findall(r"python - <<'EOF'\n(.*?)\nEOF\n", script.read_text(), re.S)
    return code


def _write_results(path: Path, rows) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file", "true_species", "pred_species", "detected", "correct", "best_distance"])
        w.writerows(rows)


def test_decision_diff_prints_what_the_reference_heredoc_prints(tmp_path, capsys):
    sp = SPECIES
    base = [[f"/d/{sp[i % 4]}/a{i}.wav", sp[i % 4], sp[i % 4], "True", "True", f"{0.5 + i / 10:.3f}"]
            for i in range(6)]
    fast = [list(r) for r in base]
    fast[2][2:5] = ["NO_DETECT", "False", "False"]  # one decision differs
    fast[4][5] = "9.999"  # a distance alone is no decision
    _write_results(tmp_path / "outputs" / "tier_balanced" / "results.csv", base)
    _write_results(tmp_path / "outputs" / "tier_fast" / "results.csv", fast)
    ref = subprocess.run([sys.executable, "-"], input=_heredoc(JSCRIPTS / "drive_fast_tier.sh"), cwd=tmp_path,
                         capture_output=True, text=True, timeout=60)
    assert ref.returncode == 0, ref.stderr
    with contextlib.chdir(tmp_path):  # the drive's own arguments
        decision_diff.main(["outputs/tier_balanced/results.csv", "outputs/tier_fast/results.csv"])
    out = capsys.readouterr().out
    assert out == ref.stdout
    assert out.splitlines()[0] == "decision equivalence: 5/6 identical (83.33%)"
    assert f"  DIFFERS /d/{sp[2]}/a2.wav: balanced=('{sp[2]}', 'True') fast=('NO_DETECT', 'False')" in out
    decision_diff.main([str(tmp_path / "outputs" / "tier_fast" / "results.csv")] * 2)
    assert capsys.readouterr().out == "decision equivalence: 6/6 identical (100.00%)\n"


def test_decision_diff_refuses_benchmarks_of_other_files(tmp_path):
    row = ["/d/x/a.wav", "x", "x", "True", "True", "0.1"]
    _write_results(tmp_path / "a.csv", [row])
    _write_results(tmp_path / "b.csv", [["/d/x/b.wav", *row[1:]]])
    with pytest.raises(SystemExit, match="different files"):
        decision_diff.main([str(tmp_path / "a.csv"), str(tmp_path / "b.csv")])


def _table(out: str) -> dict:
    rows = {}
    for line in out.splitlines():
        parts = line.split()
        if len(parts) == 5 and parts[0] in SPECIES:
            rows[parts[0]] = [float(v) for v in parts[1:]]
    return rows


def test_noise_distance_matches_the_reference_heredoc(driven, capsys):
    """The port's module on the driven project (config.json from the
    driver's last grid point) against the reference heredoc executed in
    process with the JAX package."""
    proj, r = driven
    assert r.returncode == 0, _tail(r)
    with contextlib.chdir(proj):
        noise_distance.main(["--device", "cpu"])
        got_out = capsys.readouterr().out
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            exec(compile(_heredoc(JSCRIPTS / "drive_5db_floor.sh"), "drive_5db_floor.sh", "exec"),
                 {"__name__": "__main__"})
    want_out = buf.getvalue()
    got, want = _table(got_out), _table(want_out)
    assert sorted(got) == sorted(want) == sorted(SPECIES)
    assert got_out.splitlines()[0] == want_out.splitlines()[0]
    assert got_out.split("\n\n")[1] == want_out.split("\n\n")[1]  # the reading
    for sp in SPECIES:
        assert np.isfinite(got[sp]).all()
        assert got[sp][0] == want[sp][0]  # rk, read from config.json
        np.testing.assert_allclose(got[sp][1:], want[sp][1:], rtol=2e-2, atol=1e-3)


# --- both drivers speak the same commands ---------------------------------------------------------

# sample values of the variables the scripts' command lines read
SAMPLE = {
    "CHUNKS_ROOT": "/p/latent_space_exploration", "TRAIN_CHUNKS": "/p/latent_space_exploration/train_chunks_norm",
    "VAL_CHUNKS": "/p/latent_space_exploration/val_chunks_norm",
    "TEST_CHUNKS": "/p/latent_space_exploration/test_chunks_norm", "ENCODER_DIR": "/p/models/enc",
    "CONFIG_JSON": "/p/config.json", "OUTPUTS_DIR": "/p/outputs", "GRID_ROOT": "/p/outputs/grid",
    "CHUNK_SECONDS_DEFAULT": "5.0", "QIN_DEFAULT": "0.95", "QOUT_GRID": "0.10 0.15 0.20",
    "MAX_PER_CLASS_DEFAULT": "400", "TRAIN_STEPS_DEFAULT": "2000", "DEVICE_DEFAULT": "cuda",
    "dir": "/p/latent_space_exploration/val_chunks_norm", "split": "val", "MINUTES": "30", "SNRDB": "14",
    "QI": "0.99", "QO": "0.10", "SNR": "8", "TIER": "fast",
}
COMMAND_LINE = {"port": re.compile(r"\$ANURAXLA (\S+)(.*)"),
                "jax": re.compile(r"(?:\$ANURAXLA|python -m anuraxla(?![\w.])) (\S+)(.*)")}


def _expand(text: str, env: dict, arrays: dict) -> str:
    """``text`` with the shell's parameter expansions replaced by ``env`` /
    ``arrays`` values (an unset name with a ``:-`` default takes it)."""
    text = text.replace('"$@"', "")
    text = re.sub(r'"?\$\{(\w+)\[@\]\}"?', lambda m: _expand(arrays[m[1]], env, arrays), text)
    text = re.sub(r"\$\{(\w+):-([^}]*)\}", lambda m: env.get(m[1]) or _expand(m[2], env, arrays), text)
    return re.sub(r"\$\{(\w+)\}|\$(\w+)", lambda m: env[m[1] or m[2]], text)


def _commands(script: Path, which: str) -> list:
    """-> [(command, argv)] of each CLI call in ``script``, in order."""
    text = script.read_text().replace("\\\n", " ")
    env, arrays = dict(SAMPLE), {}
    for m in re.finditer(r"^\s*(\w+)=\((.*)\)\s*$", text, re.M):
        arrays[m[1]] = m[2]
    for m in re.finditer(r"^\s*(\w+)=(\S*)\s*$", text, re.M):  # the scripts' own simple assignments
        if m[1] not in env and "$(" not in m[2]:
            env[m[1]] = _expand(m[2], env, arrays).strip('"')
    calls = []
    for line in text.splitlines():
        m = COMMAND_LINE[which].search(line)
        if m is None or line.lstrip().startswith("#"):
            continue
        lex = shlex.shlex(_expand(m[2], env, arrays), posix=True, punctuation_chars=True)
        lex.whitespace_split = True
        argv = []
        for tok in lex:
            if set(tok) <= set("|&;<>"):  # a pipe, a redirect or the next command
                break
            argv.append(tok)
        calls.append((m[1], argv))
    return calls


def _parser(package: str, command: str) -> argparse.ArgumentParser:
    """The parser of ``package``'s CLI ``command``: its ``build_parser``, or
    the parser its ``main`` builds, caught at the first ``parse_args``."""
    commands = importlib.import_module(f"{package}.cli").COMMANDS
    module = importlib.import_module(commands[command])
    if hasattr(module, "build_parser"):
        return module.build_parser()

    class Caught(Exception):
        pass

    seen = {}

    def grab(self, args=None, namespace=None):
        seen["p"] = self
        raise Caught

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        mp.setattr(sys, "argv", ["prog"])
        with pytest.raises(Caught):
            module.main() if package == "anuraxla" else module.main([])
    return seen["p"]


def _normalized(argv: list, package: str) -> list:
    """``argv`` without ``--device X``, the reference's backend name for the port's."""
    out, skip = [], False
    for i, a in enumerate(argv):
        if skip:
            skip = False
        elif a == "--device":
            skip = True
        elif package == "anuraxla_torch" and a == "cuda" and i and argv[i - 1] == "--frontend-backend":
            out.append("pallas")
        else:
            out.append(a)
    return out


PORTED_SCRIPTS = ["01_normalize_chunks.sh", "02_train_vae.sh", "03_encode_latents.sh", "04_calibrate_qout_grid.sh",
                  "05_make_plots.sh", "run_full_pipeline.sh", "drive_robustness.sh", "drive_fast_tier.sh",
                  "drive_5db_floor.sh", "drive_deep_noise_floor.sh", "drive_radial_2db.sh", "drive_tier_scans.sh"]


def test_every_reference_script_is_ported():
    have = {p.name for p in SCRIPTS.glob("*.sh")}
    assert have == {*PORTED_SCRIPTS, "_env.sh"}
    assert have <= {p.name for p in JSCRIPTS.glob("*.sh")}


@pytest.mark.parametrize("script", PORTED_SCRIPTS)
def test_commands_parse_under_both_packages(script):
    port, ref = _commands(SCRIPTS / script, "port"), _commands(JSCRIPTS / script, "jax")
    assert port and [c for c, _ in port] == [c for c, _ in ref]
    for (cmd, t_argv), (_, j_argv) in zip(port, ref):
        for package, argv in (("anuraxla_torch", t_argv), ("anuraxla", j_argv)):
            try:
                _parser(package, cmd).parse_args(argv)
            except SystemExit as e:
                raise AssertionError(f"{package} {cmd} refuses {argv}") from e
        # the port passes --device wherever a command runs on a device, always DEVICE_DEFAULT
        devices = [t_argv[i + 1] for i, a in enumerate(t_argv) if a == "--device"]
        assert devices == ([] if cmd == "make-synth-data" else ["cuda"]), (cmd, t_argv)
        assert _normalized(t_argv, "anuraxla_torch") == _normalized(j_argv, "anuraxla"), cmd
