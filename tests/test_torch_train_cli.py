"""The port's training CLIs (``anuraxla_torch.cli.{train_vae,make_synth_data,
print_latents}``) against the JAX package's, on the CPU at the small mel
config of test_torch_eval.py (16 kHz, 32 mels, 48 frames; train-vae reads 5 s
chunks, as the reference).

Tolerances: ``make-synth-data`` bytes and ``print-latents`` output equal;
``mel_batch_stream`` mels within 1e-4 (the log-mel frontend's, JAX suite),
in the same order; latents of a trained artifact within rtol 5e-4 / atol
2e-5 between the packages (the encoder tier's).
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anuraxla.cli import make_synth_data as j_synth
from anuraxla.cli import print_latents as j_print
from anuraxla.cli.train_vae import mel_batch_stream as j_stream
from anuraxla.constants import MelConfig as JMel
from anuraxla.models import checkpoint as j_ckpt
from anuraxla.models import vae as j_vae
from anuraxla_torch import __main__ as t_dispatch
from anuraxla_torch.cli import make_synth_data as t_synth
from anuraxla_torch.cli import print_latents as t_print
from anuraxla_torch.cli import train_vae as t_train_cli
from anuraxla_torch.constants import MelConfig
from anuraxla_torch.models import checkpoint as t_ckpt
from anuraxla_torch.models.vae import ConvVAEEncoder

MEL = dict(sr=16000, duration=5.0, n_mels=32, fmin=100.0, fmax=7500.0, hop_length=128, n_fft=256,
           target_frames=48)
MEL_ARGS = ["--sr", "16000", "--n-mels", "32", "--target-frames", "48", "--fmin", "100", "--fmax", "7500",
            "--hop-length", "128", "--n-fft", "256"]
TRAIN = ["--device", "cpu", "--batch-size", "8", "--latent-dim", "8", "--kl-delay", "1", "--kl-warmup", "1",
         *MEL_ARGS]
NARROW = dict(latent_dim=8, widths=(8, 16), dense_width=32, groups=4, input_hw=(48, 32))
LATENT_TOL = dict(rtol=5e-4, atol=2e-5)


def _jax_main(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    module.main()


def _files(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("argv", [
    ["--sr", "16000", "--seconds", "0.5", "--per-species", "2", "--seed", "3"],
    ["--sr", "16000", "--minutes", "0.05", "--plant", "1@1.0", "--plant", "3@2.0", "--call-seconds", "0.5",
     "--snr-db", "10", "--seed", "4"],
], ids=["tree", "soundscape"])
def test_make_synth_data_writes_the_jax_bytes(tmp_path, monkeypatch, capsys, argv):
    def where(d):
        return ["--root", str(d)] if "--per-species" in argv else ["--soundscape", str(d / "rec.wav")]

    _jax_main(monkeypatch, j_synth, [*argv, *where(tmp_path / "j")])
    jout = capsys.readouterr().out
    t_synth.main([*argv, *where(tmp_path / "t")])
    tout = capsys.readouterr().out
    j, t = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert len(j) > 1 if "--per-species" in argv else len(j) == 1
    assert j == t
    assert tout == jout.replace(str(tmp_path / "j"), str(tmp_path / "t"))


def _tree(root: Path, n_per: int = 3, seed: int = 0) -> Path:
    t_synth.make_tree(root, sr=16000, seconds=5.0, per_species=n_per, splits=("train_chunks",), seed=seed)
    return root / "train_chunks"


@pytest.mark.parametrize("backend", ["matmul", "cuda"])
def test_mel_batch_stream_matches_jax(tmp_path, backend):
    """Same file order (every epoch's shuffle), same mels; a truncated WAV
    and the padded tail rows replaced by good rows as in the reference."""
    root = _tree(tmp_path / "d", n_per=2, seed=1)
    good = next(root.rglob("*.wav")).read_bytes()
    (root / "Pleurodema_thaul" / "zz_truncated.wav").write_bytes(good[:30])
    kw = dict(batch_size=4, io_threads=2, epochs=2)
    want = list(j_stream(root, JMel(**MEL), parity=True, backend="matmul", **kw))
    got = list(t_train_cli.mel_batch_stream(root, MelConfig(**MEL), parity=True, backend=backend, device="cpu",
                                             **kw))
    # 9 files, 3 batches an epoch; one epoch's last batch holds only the
    # truncated file, has no good row and is skipped
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape == (4, 48, 32, 1)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _tree(tmp_path_factory.mktemp("traintree"))


@pytest.fixture
def project(tmp_path, monkeypatch):
    """An empty project root (config.json next to models/) as the working
    directory."""
    (tmp_path / "models").mkdir()
    (tmp_path / "config.json").write_text(json.dumps({"chunk_seconds": 5.0}))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", list(sys.argv))  # the dispatcher rewrites it
    return tmp_path


def _mels(tree_root: Path, n: int = 4) -> np.ndarray:
    batch = next(t_train_cli.mel_batch_stream(tree_root, MelConfig(**MEL), n, 2, 1, backend="matmul", device="cpu"))
    return batch.numpy()


def _same_mu(enc_dir: Path, x: np.ndarray) -> None:
    """The artifact's mu in the JAX package equals the port's."""
    enc, params, _ = j_ckpt.load_encoder(enc_dir)
    want = np.asarray(enc.apply(params, jnp.asarray(x))["mu"], np.float32)
    state, cfg = t_ckpt.load_encoder(enc_dir)
    model = ConvVAEEncoder(cfg)
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.from_numpy(x))["mu"].numpy()
    np.testing.assert_allclose(got, want, **LATENT_TOL)


def test_train_vae_artifacts_load_in_jax_and_resume(tree, project, capsys):
    out = project / "models" / "anuraxla_vae_encoder_v0"
    t_dispatch.main(["train-vae", "--root", str(tree), "--steps", "3", "--ckpt-dir", "ckpt", "--save-decoder",
                     *TRAIN])
    log = capsys.readouterr().out
    assert "step 0: loss=" in log and "🏁 3 steps" in log and f"💾 encoder artifact: {out}" in log
    x = _mels(tree)
    _same_mu(out, x)
    # the full VAE: the JAX package's load_vae, its encoder equal to the encoder artifact
    _, vparams, vcfg = j_ckpt.load_vae(Path(str(out) + "_full"))
    _, eparams, ecfg = j_ckpt.load_encoder(out)
    assert vcfg == ecfg and vcfg.input_hw == (48, 32) and vcfg.latent_dim == 8
    for a, b in zip(jax_leaves(j_vae.encoder_params_from_vae(vparams)), jax_leaves(eparams)):
        np.testing.assert_array_equal(a, b)
    assert t_ckpt.latest_step(project / "ckpt") == 3

    t_dispatch.main(["02", "--root", str(tree), "--steps", "2", "--ckpt-dir", "ckpt", "--resume", *TRAIN])
    log = capsys.readouterr().out
    assert "▶ resumed from step 3 in ckpt" in log
    assert t_ckpt.latest_step(project / "ckpt") == 5
    resumed, _ = t_ckpt.load_encoder(out)
    before = {k.split("encoder.", 1)[1]: v for k, v in torch.load(
        project / "ckpt" / "3" / "train_state.pt", weights_only=True)["model"].items() if k.startswith("encoder.")}
    assert any(not torch.equal(resumed[k], before[k]) for k in before)  # training went on from step 3


def jax_leaves(tree):
    import jax

    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("downsample", ["stride", "avgpool"])
def test_train_vae_init_from_jax_artifact(tree, project, capsys, downsample):
    jcfg = j_vae.VAEConfig(**NARROW, downsample=downsample)
    _, params = j_vae.init_encoder(jcfg, seed=2)
    j_ckpt.save_encoder(project / "init", jcfg, params)
    argv = ["--root", str(tree), "--steps", "2", "--init-from", "init", "--out", "warm", "--ckpt-dir", "ck",
            *TRAIN, "--latent-dim", "16"]
    t_train_cli.main(argv)
    log = capsys.readouterr().out
    assert "ℹ️ --init-from overrides latent_dim: 8" in log and "▶ warm start: encoder from init, decoder random-init" in log
    state, cfg = t_ckpt.load_encoder(project / "warm")
    assert cfg.downsample == downsample and cfg.widths == (8, 16) and cfg.latent_dim == 8
    start, _ = t_ckpt.load_encoder(project / "init")
    assert state.keys() == start.keys()
    moved = max(float((state[k] - start[k]).abs().max()) for k in state)
    assert 0 < moved < 0.05  # two small steps from the artifact's weights, not a fresh init
    _same_mu(project / "warm", _mels(tree))
    # --resume with --init-from: the architecture from the artifact, the weights from the checkpoint
    t_train_cli.main([*argv[:-2], "--resume", "--steps", "1", "--out", "warm2"])
    assert "▶ resumed from step 2 in ck" in capsys.readouterr().out
    assert t_ckpt.load_encoder(project / "warm2")[1] == cfg


def test_train_vae_init_from_decoder(tree, project, capsys):
    jcfg = j_vae.VAEConfig(**NARROW)
    _, eparams = j_vae.init_encoder(jcfg, seed=3)
    j_ckpt.save_encoder(project / "enc", jcfg, eparams)
    spec = j_vae.DecoderSpec(latent_dim=8, dense_widths=(16, 12 * 8 * 6), bottleneck_hw=(12, 8), bottleneck_c=6,
                             stack=(("convt", 6), ("upconv", 4), ("conv", 1)), groups=2)
    _, dparams = j_vae.init_ingested_decoder(spec, seed=4)
    j_ckpt.save_decoder(project / "dec", spec, dparams)
    t_train_cli.main(["--root", str(tree), "--steps", "2", "--init-from", "enc", "--init-from-decoder", "dec",
                      "--save-decoder", "--out", "warm", *TRAIN])
    log = capsys.readouterr().out
    assert "decoder from dec" in log and "💾 decoder artifact (ingested structure)" in log
    _, back, bspec = j_ckpt.load_decoder(project / "warm_decoder")
    assert bspec == spec
    d = [float(np.abs(a - b).max()) for a, b in zip(jax_leaves(back), jax_leaves(dparams))]
    assert 0 < max(d) < 0.05


@pytest.mark.parametrize("argv,match", [
    (["--init-from-decoder", "dec"], "requires --init-from"),
    (["--resume"], "requires --ckpt-dir"),
    (["--init-from", "enc", "--target-frames", "40"], "consumes"),
], ids=["decoder-alone", "resume-alone", "geometry"])
def test_train_vae_refusals(tree, project, argv, match):
    j_ckpt.save_encoder(project / "enc", j_vae.VAEConfig(**NARROW), j_vae.init_encoder(j_vae.VAEConfig(**NARROW))[1])
    with pytest.raises(SystemExit, match=match):
        t_train_cli.main(["--root", str(tree), "--steps", "1", *TRAIN, *argv])


def test_train_vae_devices(tree, project, capsys):
    """Defaults to the card; --data-parallel over one device is the
    single-device loop, over several shards the sharded loop (its log names
    the mesh, as the reference's does), where --resume and --init-from are
    refused with the reference's messages."""
    from anuraxla_torch.parallel import mesh as t_mesh

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cuda'"):
            t_train_cli.main(["--root", str(tree), "--steps", "1"])
    t_train_cli.main(["--root", str(tree), "--steps", "1", "--data-parallel", "--ckpt-dir", "ck", *TRAIN])
    out = capsys.readouterr().out
    assert "🏁 1 steps" in out and "step 0: loss=" in out
    j_ckpt.save_encoder(project / "enc", j_vae.VAEConfig(**NARROW), j_vae.init_encoder(j_vae.VAEConfig(**NARROW))[1])
    t_mesh.set_default_devices(["cpu"] * 2)
    try:
        t_train_cli.main(["--root", str(tree), "--steps", "1", "--data-parallel", *TRAIN])
        out = capsys.readouterr().out
        assert "step 0 [2dp x 1tp]: loss=" in out and "🏁 1 steps" in out
        for argv, match in ((["--resume", "--ckpt-dir", "ck"], "--resume with --data-parallel is not supported"),
                            (["--init-from", "enc"], "--init-from with --data-parallel is not supported")):
            with pytest.raises(SystemExit, match=match):
                t_train_cli.main(["--root", str(tree), "--steps", "1", "--data-parallel", *TRAIN, *argv])
    finally:
        t_mesh.set_default_devices(None)


@pytest.mark.parametrize("flags", [[], ["--n", "3"], ["--all", "--jsonl"], ["--show-cols", "--precision", "3"]],
                         ids=["default", "n3", "jsonl", "cols"])
def test_print_latents_prints_what_jax_prints(tmp_path, monkeypatch, capsys, flags):
    Z = np.random.default_rng(5).standard_normal((4, 6)).astype(np.float32)
    np.savez(tmp_path / "latents.npz", Z=Z, paths=np.array([f"a{i}.wav" for i in range(4)]))
    argv = ["--parquet", str(tmp_path / "latents.npz"), *flags]
    _jax_main(monkeypatch, j_print, argv)
    want = capsys.readouterr().out
    t_dispatch.main(["06", *argv])
    assert capsys.readouterr().out == want and "latent dim: 6" in want


def test_print_latents_parquet_without_pandas(tmp_path, monkeypatch):
    (tmp_path / "features.parquet").write_bytes(b"PAR1")
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(SystemExit, match="needs pandas"):
        t_print.main(["--parquet", str(tmp_path / "features.parquet")])


@pytest.mark.parametrize("alias,cmd", [("02", "train-vae"), ("06", "print-latents"),
                                       ("make-synth-data", "make-synth-data")])
def test_dispatcher_runs_the_training_commands(monkeypatch, capsys, alias, cmd):
    monkeypatch.setattr(sys, "argv", list(sys.argv))  # the dispatcher rewrites it
    with pytest.raises(SystemExit) as e:
        t_dispatch.main([alias, "--help"])
    assert e.value.code == 0 and f"anuraxla_torch {cmd}" in capsys.readouterr().out
