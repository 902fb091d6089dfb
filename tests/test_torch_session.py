"""The port's serving slice held against the JAX package on the CPU:
``radial_decide``, the WAV loader, noise injection, and the whole path at
full width (DEFAULT_MEL, default VAEConfig, 3 WAVs) — the port's
``EncoderSession`` -> ``detect_species`` against JAX's on the same params.
Also the import guard: the port and chip_smoke.py import no JAX, flax,
msgpack or ``anuraxla``."""

import ast
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anuraxla.cli.evaluate_wav import detect_species as j_detect_species
from anuraxla.config import priority_ranks as j_priority_ranks
from anuraxla.config import read_radial as j_read_radial
from anuraxla.constants import DEFAULT_MEL as J_DEFAULT_MEL
from anuraxla.detect.radial import radial_decide as j_radial_decide
from anuraxla.pipeline.dataset import iter_batches as j_iter_batches
from anuraxla.pipeline.dataset import load_wav_batch as j_load_wav_batch
from anuraxla.pipeline.session import EncoderSession as JSession
from anuraxla.utils.wavio import read_wav as j_read_wav
from anuraxla_torch.cli import evaluate_wav as t_cli
from anuraxla_torch.config import priority_ranks, read_radial
from anuraxla_torch.constants import DEFAULT_MEL, PRIORITY_ORDER, MelConfig
from anuraxla_torch.detect.radial import radial_decide
from anuraxla_torch.models.convert import encoder_state_from_jax
from anuraxla_torch.models.vae import VAEConfig
from anuraxla_torch.ops.mel_kernel import phase_padded_layout
from anuraxla_torch.pipeline.dataset import iter_batches, load_wav_batch
from anuraxla_torch.pipeline.session import EncoderSession
from anuraxla_torch.utils.wavio import read_wav, write_wav

REPO = Path(__file__).resolve().parent.parent


def test_radial_decide_matches_jax():
    rng = np.random.default_rng(11)
    K, D = 4, 8
    cent = rng.standard_normal((K, D)).astype(np.float32)
    Z = rng.standard_normal((6, D)).astype(np.float32)
    Z[0] = cent[2]  # on a centroid
    Z[1] = (cent[0] + cent[3]) / 2  # equidistant: a tie both accept
    Z[5] = 100.0  # no accept
    thr = np.full(K, 2.5, np.float32)
    thr[[0, 3]] = np.linalg.norm(Z[1] - cent[0]) * 1.01
    species = ["Pleurodema_thaul", "zeta_sp", "alpha_sp", "Batrachyla_leptopus"]
    ranks = priority_ranks(species)
    assert np.array_equal(ranks, j_priority_ranks(species))
    dj, wj, bj = j_radial_decide(jnp.asarray(Z), jnp.asarray(cent), jnp.asarray(thr), jnp.asarray(ranks))
    dt, wt, bt = radial_decide(*(torch.from_numpy(a) for a in (Z, cent, thr, ranks)))
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    assert np.array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-6)
    assert wt[1] == 3 and wt[5] == -1 and not dt[5]  # priority beats index; no accept


def _write_wavs(d: Path, cfg: MelConfig, n: int, seed: int):
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.num_samples) / cfg.sr
    paths = []
    for i in range(n):
        y = 0.3 * np.sin(2 * np.pi * (700 + 900 * i) * t) * (rng.random(t.size) > 0.3)
        y = y + 0.02 * rng.standard_normal(t.size)
        p = d / f"c{i}.wav"
        write_wav(p, y.astype(np.float32), cfg.sr)
        paths.append(p)
    return paths


def test_wav_loading_matches_jax(tmp_path):
    cfg = MelConfig(sr=16000, duration=0.5, hop_length=128, n_fft=256, n_mels=32, target_frames=48)
    paths = _write_wavs(tmp_path, cfg, 3, seed=1) + [tmp_path / "missing.wav"]
    (tmp_path / "stereo.wav").write_bytes(b"")
    y, sr = read_wav(paths[0], sr=8000)
    yj, srj = j_read_wav(paths[0], sr=8000)
    assert sr == srj and np.array_equal(y, yj)
    layout = phase_padded_layout(cfg, cfg.total_frames)
    kw = dict(sr=cfg.sr, num_samples=cfg.num_samples, layout=layout)
    b = load_wav_batch(paths, **kw)
    bj = j_load_wav_batch(paths, use_native=False, **kw)
    assert np.array_equal(b.audio, bj.audio) and np.array_equal(b.ok, bj.ok)
    assert b.ok.tolist() == [True, True, True, False] and b.errors[3]
    got = [(x.audio, n) for x, n in iter_batches(paths, batch_size=3, **kw)]
    want = [(x.audio, n) for x, n in j_iter_batches(paths, batch_size=3, **kw)]
    assert [n for _, n in got] == [n for _, n in want] == [3, 1]
    assert all(np.array_equal(a, w) for (a, _), (w, _) in zip(got, want))


def test_noise_injection_matches_jax():
    cfg = DEFAULT_MEL.replace(duration=0.25)
    rng = np.random.default_rng(2)
    audio = (0.1 * rng.standard_normal((3, cfg.num_samples))).astype(np.float32)
    audio[2] = 0.0
    t = EncoderSession(mel=cfg, add_noise_db=6.0, noise_seed=4, device="cpu")
    t._layout = None
    j = JSession(mel=J_DEFAULT_MEL.replace(duration=0.25), add_noise_db=6.0, noise_seed=4)
    j._layout = None
    assert np.array_equal(t._inject_noise(audio, 5, 3), j._inject_noise(audio, 5, 3))


def test_transfer_int16_is_lossless_for_pcm16(tmp_path):
    """PCM16 sources cross the link as int16 and give the float path's
    latents exactly."""
    cfg = DEFAULT_MEL.replace(duration=1.0)
    paths = _write_wavs(tmp_path, cfg, 2, seed=6)
    kw = dict(mel=cfg, device="cpu", normalize_on_device=True, pre_padded_host=True, init_seed=1)
    Zf, _, _ = EncoderSession(**kw).load().encode_paths(paths)
    Zi, _, _ = EncoderSession(**kw, transfer_int16=True).load().encode_paths(paths)
    assert np.array_equal(Zf, Zi)


def _radial_config(d: Path, Z: np.ndarray) -> Path:
    sp = list(PRIORITY_ORDER[:2])
    d0 = np.sort(np.linalg.norm(Z - Z[0], axis=1))
    cfg = {
        "species": sp, "chunk_seconds": 5.0,
        "radial_detector": {
            "centroids": {sp[0]: Z[0].tolist(), sp[1]: Z[1].tolist()},
            "thresholds": {sp[0]: float(d0[1] + d0[2]) / 2, sp[1]: 1e-3},
        },
    }
    path = d / "config.json"
    path.write_text(json.dumps(cfg))
    return path


def test_full_width_slice_matches_jax(tmp_path):
    """DEFAULT_MEL and the default VAEConfig end to end: decode -> fused
    RMS -> mel (the kernel's plain version on CPU) -> encoder -> radial."""
    paths = _write_wavs(tmp_path, DEFAULT_MEL, 3, seed=3)
    js = JSession(mel=J_DEFAULT_MEL, backend="matmul", normalize_on_device=True,
                  project_root=tmp_path, batch_size=2).load()
    Zj, okj, _ = js.encode_paths(paths)
    params = encoder_state_from_jax(jax.tree_util.tree_map(np.asarray, js._params), VAEConfig())
    ts = EncoderSession(mel=DEFAULT_MEL, device="cpu", normalize_on_device=True,
                        pre_padded_host=True, batch_size=2).load(params)
    Zt, okt, _ = ts.encode_paths(paths)
    assert okt.all() and okj.all() and Zt.shape == (3, 128)
    np.testing.assert_allclose(Zt, Zj, rtol=5e-4, atol=2e-5)

    cfg_path = _radial_config(tmp_path, Zj)
    assert [a.tolist() if hasattr(a, "tolist") else a for a in read_radial(json.loads(cfg_path.read_text()))] == \
           [a.tolist() if hasattr(a, "tolist") else a for a in j_read_radial(json.loads(cfg_path.read_text()))]
    decisions = []
    for p in paths:
        dt, spt, bt = t_cli.detect_species(p, ts, cfg_path)
        dj, spj, bj = j_detect_species(p, js, cfg_path)
        assert (dt, spt) == (dj, spj)
        assert (0 if dt else 2) == (0 if dj else 2)  # the CLI's exit code
        np.testing.assert_allclose(bt, bj, rtol=5e-4, atol=2e-5)
        decisions.append(dt)
    assert decisions == [True, True, False]


def test_cli_exit_codes(tmp_path, capsys):
    """The port's CLI: exit 0 with the ✅ line on a detect, 2 with ❌."""
    cfg = DEFAULT_MEL.replace(duration=1.0)
    paths = _write_wavs(tmp_path, cfg, 2, seed=4)
    sess = EncoderSession(mel=cfg, device="cpu", batch_size=1, init_seed=7).load()
    Z = sess.encode_array(np.stack([read_wav(p)[0] for p in paths]))
    sp = PRIORITY_ORDER[0]
    radius = 0.5 * float(np.linalg.norm(Z[1] - Z[0]))
    cfgj = {"species": [sp], "chunk_seconds": 1.0,
            "radial_detector": {"centroids": {sp: Z[0].tolist()}, "thresholds": {sp: radius}}}
    (tmp_path / "config.json").write_text(json.dumps(cfgj))
    args = ["--config", str(tmp_path / "config.json"), "--device", "cpu", "--init-seed", "7"]
    for p, code, mark in ((paths[0], 0, "✅ DETECTED: " + sp), (paths[1], 2, "❌ NO DETECT")):
        with pytest.raises(SystemExit) as e:
            t_cli.main(["--wav", str(p), *args])
        assert e.value.code == code
        assert mark in capsys.readouterr().out


def test_entry_points_need_a_card_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        EncoderSession(mel=DEFAULT_MEL).load()
    wav = _write_wavs(tmp_path, DEFAULT_MEL.replace(duration=0.1), 1, seed=5)[0]
    (tmp_path / "config.json").write_text(json.dumps({"chunk_seconds": 5.0}))
    with pytest.raises(RuntimeError, match="device='cuda'"):
        t_cli.main(["--wav", str(wav), "--config", str(tmp_path / "config.json")])


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    pkg = REPO / "anuraxla_torch"
    files = sorted(f for f in pkg.rglob("*.py") if "_build" not in f.relative_to(pkg).parts)
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    covered = {str(f.relative_to(REPO)) for f in files}
    assert {"anuraxla_torch/bench.py", "anuraxla_torch/probes/common.py", "anuraxla_torch/probes/kernel_variants.py",
            "anuraxla_torch/probes/phase_variants.py", "anuraxla_torch/probes/kernel_ablation.py",
            "anuraxla_torch/probes/profile_stages.py", "anuraxla_torch/native/wavloader.py",
            "anuraxla_torch/models/checkpoint.py", "anuraxla_torch/pipeline/fit.py",
            "anuraxla_torch/cli/fit_map.py", "anuraxla_torch/__main__.py", "anuraxla_torch/cli/__init__.py",
            "anuraxla_torch/detect/calibrate.py", "anuraxla_torch/pipeline/benchmark.py",
            "anuraxla_torch/pipeline/stream.py", "anuraxla_torch/utils/timing.py", "anuraxla_torch/utils/metrics.py",
            "anuraxla_torch/utils/plotting.py", "anuraxla_torch/cli/benchmark_folder.py",
            "anuraxla_torch/cli/benchmark_folder_map.py", "anuraxla_torch/cli/calibrate_tau.py",
            "anuraxla_torch/cli/run_qout_grid.py", "anuraxla_torch/cli/scan_soundscape.py",
            "anuraxla_torch/cli/encode_wav.py", "anuraxla_torch/cli/normalize.py",
            "anuraxla_torch/cli/snapshot_from_log.py", "anuraxla_torch/cli/spearman_analysis.py",
            "anuraxla_torch/models/train.py", "anuraxla_torch/cli/train_vae.py", "anuraxla_torch/cli/make_synth_data.py",
            "anuraxla_torch/cli/print_latents.py", "anuraxla_torch/models/quant.py", "anuraxla_torch/ops/int8.py",
            "anuraxla_torch/models/ingest.py", "anuraxla_torch/models/hydra_ingest.py",
            "anuraxla_torch/cli/ingest_encoder.py", "anuraxla_torch/cli/ingest_decoder.py",
            "anuraxla_torch/parallel/mesh.py", "anuraxla_torch/parallel/encode.py", "anuraxla_torch/parallel/fit.py",
            "anuraxla_torch/parallel/train_sharded.py", "anuraxla_torch/parallel/multihost.py",
            "anuraxla_torch/scripts/__init__.py", "anuraxla_torch/scripts/decision_diff.py",
            "anuraxla_torch/scripts/noise_distance.py", "anuraxla_torch/probes/encoder_variants.py",
            "anuraxla_torch/probes/train_step.py", "anuraxla_torch/probes/cold_io.py"} <= covered
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "msgpack", "anuraxla"), (f, mod)


# a call of the JAX package from a shell script: its CLI, or an import in an inline Python block
JAX_CALL = re.compile(r"python3? -m anuraxla(?!_torch)\b|^\s*import anuraxla(?!_torch)\b|^\s*from anuraxla[.\s]",
                      re.M)


def test_port_scripts_call_no_jax():
    """The port's shell scripts run ``python -m anuraxla_torch`` only, and
    their inline Python imports nothing of the JAX package; the same scan
    finds the reference's calls in ``scripts/``."""
    scripts = sorted((REPO / "anuraxla_torch" / "scripts").glob("*.sh"))
    assert {p.name for p in scripts} >= {"_env.sh", "run_full_pipeline.sh", "01_normalize_chunks.sh",
                                         "05_make_plots.sh", "drive_fast_tier.sh", "drive_5db_floor.sh"}
    for f in scripts:
        assert not JAX_CALL.findall(f.read_text()), (f.name, JAX_CALL.findall(f.read_text()))
    assert "python -m anuraxla_torch" in (REPO / "anuraxla_torch" / "scripts" / "_env.sh").read_text()
    ref = {p.name: JAX_CALL.findall(p.read_text()) for p in (REPO / "scripts").glob("*.sh")}
    assert ref["_env.sh"] and ref["drive_fast_tier.sh"] and ref["drive_5db_floor.sh"]
    assert any(m.strip().startswith("from anuraxla") for m in ref["run_full_pipeline.sh"])
