"""Real ``torch.distributed`` gloo clusters on localhost for the port's
multi-process helpers (``anuraxla_torch.parallel.multihost``): 2 processes
joined through the standard launcher's variables, each with 2 CPU shards of
its own (both levels of the mesh at once), and 4 processes joined through
``initialize_multihost``'s arguments, 1 shard each — a data axis of 4 either
way. The workers are this file run as a script; they import torch and the
port, never JAX:

    python tests/test_torch_multihost.py worker <port> <rank> <world> <shards> <out.json> [env]

The parent checks: rank, world size and mesh shape; the path shards disjoint
and covering; the sharded fits and quantile replicated bitwise across ranks
and equal to the single-process fits of both packages (the tolerances of
``tests/test_parallel.py:443-560``); the sharded encode equal on every rank
and to the unsharded forward; a data-parallel ``EncoderSession`` process-local
(no group in its mesh), each rank's latents of its own WAVs those of the
single-process session; one sharded train step's loss equal on every rank and
to the unsharded step's. Every process has its own timeout and a
run that outlasts it fails."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
N_PATHS = 11
TIMEOUT_S = 90


def pool():
    """The deterministic latent pool every process holds alike."""
    rng = np.random.default_rng(7)
    K, N, D = 3, 32, 6
    Z = rng.normal(size=(K, N, D)).astype(np.float32)
    mask = np.ones((K, N), bool)
    mask[1, 28:] = False
    return Z, mask


def encode_fixture():
    """(mel, cfg, encoder, audio): a seeded toy encoder and 8 rows, 2 a
    shard at the largest cluster the file spawns."""
    import torch

    from anuraxla_torch.constants import MelConfig
    from anuraxla_torch.models.vae import ConvVAEEncoder, VAEConfig, init_encoder_params

    mel = MelConfig(duration=0.25, target_frames=32, n_mels=32, sr=16000, fmax=7000)
    cfg = VAEConfig(latent_dim=16, widths=(8, 16), dense_width=32, groups=4, input_hw=(32, 32))
    enc = ConvVAEEncoder(cfg)
    enc.load_state_dict(init_encoder_params(cfg, torch.Generator().manual_seed(0)))
    audio = 0.1 * np.random.default_rng(1).standard_normal((8, mel.num_samples)).astype(np.float32)
    return mel, cfg, enc.eval(), audio


def encode_session(mel, cfg, enc, data_parallel: bool):
    """A CPU session of the toy encoder, 2 rows a batch."""
    from anuraxla_torch.pipeline.session import EncoderSession

    return EncoderSession(mel=mel, encoder_cfg=cfg, backend="matmul", device="cpu", batch_size=2, num_threads=1,
                          data_parallel=data_parallel).load(enc.state_dict())


def train_fixture():
    """(cfg, tc, batch, eps) of one small train step."""
    from anuraxla_torch.models.train import TrainConfig
    from anuraxla_torch.models.vae import VAEConfig

    cfg = VAEConfig(latent_dim=8, widths=(8,), dense_width=16, groups=4, input_hw=(16, 16))
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10, beta=0.1, seed=3)
    rng = np.random.default_rng(5)
    return cfg, tc, rng.standard_normal((8, 16, 16, 1)).astype(np.float32), \
        rng.standard_normal((8, 8)).astype(np.float32)


def run_worker(port: int, rank: int, world: int, shards: int, out: str, env_init: bool) -> None:
    import torch
    import torch.distributed as dist

    from anuraxla_torch.models.train import create_train_state
    from anuraxla_torch.parallel.encode import make_sharded_encode
    from anuraxla_torch.parallel import mesh as pmesh
    from anuraxla_torch.parallel.fit import fit_map_sharded, fit_radial_sharded, sharded_quantile
    from anuraxla_torch.parallel.mesh import make_mesh, psum
    from anuraxla_torch.parallel.multihost import global_mesh, initialize_multihost, shard_paths_for_host
    from anuraxla_torch.parallel.train_sharded import make_sharded_train_step, shard_state

    torch.set_num_threads(1)
    if env_init:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        ok = initialize_multihost(device="cpu")
    else:
        ok = initialize_multihost(f"127.0.0.1:{port}", num_processes=world, process_id=rank, device="cpu")
    mesh = make_mesh(devices=["cpu"] * shards)
    res = {"initialized": ok, "rank": dist.get_rank(), "world": dist.get_world_size(),
           "mesh_shape": mesh.shape, "global_mesh_shape": global_mesh(device="cpu").shape,
           "shard": [str(p) for p in shard_paths_for_host([f"f{i:03d}.wav" for i in range(N_PATHS)])],
           "psum": psum([torch.tensor([rank * shards + i + 1.0]) for i in range(shards)], mesh).tolist()}

    Z, mask = pool()
    mfit = fit_map_sharded(Z, mask, mesh=mesh, cov_type="lda", cov_structure="full", priors_mode="empirical",
                           eps=1e-6, shrink=0.0, tau_q=0.1)
    res.update(map_means=mfit.means.tolist(), map_logdets=mfit.logdets.tolist(), map_priors=mfit.priors.tolist(),
               map_tau=float(mfit.tau))
    rfit = fit_radial_sharded(Z, mask, 0.9, 0.2, mesh=mesh)
    res.update(radial_centroids=rfit.centroids.tolist(), radial_rk=rfit.rk.tolist(),
               radial_rk_in=rfit.rk_in.tolist(), radial_rk_out=rfit.rk_out.tolist(),
               quantile=sharded_quantile(Z[..., 0], mask, 0.37, mesh=mesh, n_bins=64).tolist())

    mel, cfg, enc, audio = encode_fixture()
    res["encode_z"] = make_sharded_encode(mesh, enc, mel, backend="matmul")(audio).tolist()
    # a data-parallel session encodes this rank's own WAVs over its own shards
    mine = shard_paths_for_host(sorted((Path(out).parent / "wavs").glob("*.wav")))
    pmesh.set_default_devices(["cpu"] * shards)
    sess = encode_session(mel, cfg, enc, data_parallel=True)
    pmesh.set_default_devices(None)
    Z, ok, _ = sess.encode_paths(mine)
    res["session_mesh"] = None if sess._mesh is None else [sess._mesh.shape, sess._mesh.group is None]
    res["session_z"] = {p.name: z.tolist() for p, z in zip(mine, Z)} if ok.all() else None

    cfg, tc, batch, eps = train_fixture()
    _, state = create_train_state(cfg, tc, device="cpu")
    ss, _ = shard_state(state, mesh)
    ss, m = make_sharded_train_step(tc.beta, mesh)(ss, torch.from_numpy(batch), torch.from_numpy(eps))
    res["train_loss"] = float(m["loss"])
    res["train_param_sum"] = float(sum(p.detach().double().sum() for p in ss.state.model.parameters()))
    dist.destroy_process_group()
    Path(out).write_text(json.dumps(res))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cluster(tmp_path, world: int, shards: int, env_init: bool) -> list:
    """Spawn ``world`` workers on a fresh localhost port; fail (not skip) on
    a timeout or a non-zero exit. -> their result dicts in rank order."""
    import pytest

    from anuraxla_torch.utils.wavio import write_wav

    (tmp_path / "wavs").mkdir()
    mel = encode_fixture()[0]
    rng = np.random.default_rng(11)
    for i in range(N_PATHS):
        write_wav(tmp_path / "wavs" / f"f{i:03d}.wav", 0.1 * rng.standard_normal(mel.num_samples), mel.sr)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    port = _free_port()
    outs = [tmp_path / f"w{r}.json" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "worker", str(port), str(r), str(world), str(shards), str(outs[r])]
        + (["env"] if env_init else []),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"{world}-process gloo cluster did not finish within {TIMEOUT_S} s")
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(logs)
    return [json.loads(o.read_text()) for o in outs]


def _check(res, world: int, shards: int, tmp_path):
    import jax.numpy as jnp
    import torch

    from anuraxla.detect.gaussian_map import fit_map as j_fit_map
    from anuraxla.detect.radial import fit_radial as j_fit_radial
    from anuraxla_torch.detect.gaussian_map import fit_map
    from anuraxla_torch.detect.radial import fit_radial
    from anuraxla_torch.models.train import create_train_state, make_train_step
    from anuraxla_torch.ops.frontend import log_mel_batch, mel_to_encoder_input
    from anuraxla_torch.ops.quantiles import masked_quantile

    n_data = world * shards
    for rank, r in enumerate(res):
        assert r["initialized"] is True and r["rank"] == rank and r["world"] == world
        assert r["mesh_shape"] == {"data": n_data, "model": 1}
        assert r["global_mesh_shape"] == {"data": world, "model": 1}
        assert r["psum"] == [n_data * (n_data + 1) / 2]
    paths = [f"f{i:03d}.wav" for i in range(N_PATHS)]
    flat = [p for r in res for p in r["shard"]]
    assert sorted(flat) == paths and len(set(flat)) == len(paths)

    keys = ("map_means", "map_logdets", "map_priors", "map_tau", "radial_centroids", "radial_rk", "radial_rk_in",
            "radial_rk_out", "quantile", "encode_z", "train_loss", "train_param_sum")
    for r in res[1:]:
        for key in keys:  # replicated: bitwise on every rank
            assert r[key] == res[0][key], key

    Z, mask = pool()
    kw = dict(cov_type="lda", cov_structure="full", priors_mode="empirical", eps=1e-6, shrink=0.0, tau_q=0.1)
    for ref_m, ref_r in ((fit_map(torch.from_numpy(Z), torch.from_numpy(mask), **kw),
                          fit_radial(torch.from_numpy(Z), torch.from_numpy(mask), 0.9, 0.2)),
                         (j_fit_map(jnp.asarray(Z), jnp.asarray(mask), **kw),
                          j_fit_radial(jnp.asarray(Z), jnp.asarray(mask), 0.9, 0.2))):
        np.testing.assert_allclose(res[0]["map_means"], np.asarray(ref_m.means), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(res[0]["map_logdets"], np.asarray(ref_m.logdets), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(res[0]["map_tau"], float(ref_m.tau), rtol=2e-4)
        np.testing.assert_allclose(res[0]["radial_centroids"], np.asarray(ref_r.centroids), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(res[0]["radial_rk"], np.asarray(ref_r.rk), rtol=2e-4, atol=2e-5)
    exact = masked_quantile(torch.from_numpy(Z[..., 0]), torch.from_numpy(mask), 0.37)
    np.testing.assert_allclose(res[0]["quantile"], exact.numpy(), rtol=3e-7, atol=0.0)

    mel, cfg, enc, audio = encode_fixture()
    with torch.no_grad():
        ref = enc(mel_to_encoder_input(log_mel_batch(torch.from_numpy(audio), mel, backend="matmul")))["mu"]
    np.testing.assert_allclose(res[0]["encode_z"], ref.numpy(), rtol=2e-5, atol=2e-6)

    wavs = sorted((tmp_path / "wavs").glob("*.wav"))
    Z, ok, _ = encode_session(mel, cfg, enc, data_parallel=False).encode_paths(wavs)
    assert ok.all()
    for rank, r in enumerate(res):
        assert r["session_mesh"] == (None if shards == 1 else [{"data": shards, "model": 1}, True])
        assert list(r["session_z"]) == [p.name for p in wavs[rank::world]]
        np.testing.assert_allclose(np.array(list(r["session_z"].values())), Z[rank::world], rtol=2e-4, atol=2e-5)

    cfg, tc, batch, eps = train_fixture()
    _, state = create_train_state(cfg, tc, device="cpu")
    state, m = make_train_step(tc.beta)(state, torch.from_numpy(batch), torch.from_numpy(eps))
    np.testing.assert_allclose(res[0]["train_loss"], float(m["loss"]), rtol=1e-4)
    np.testing.assert_allclose(res[0]["train_param_sum"],
                               float(sum(p.detach().double().sum() for p in state.model.parameters())), rtol=1e-4)


def test_initialize_multihost_degrades_off_cluster(monkeypatch):
    """No arguments and no launcher variables: the single-process no-op."""
    import torch.distributed as dist

    from anuraxla_torch.parallel.multihost import LAUNCHER_VARS, initialize_multihost

    for var in (*LAUNCHER_VARS, "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() is False
    assert initialize_multihost(device="cpu") is False
    assert not dist.is_initialized()


def test_two_process_cluster_by_launcher_variables(tmp_path):
    _check(_cluster(tmp_path, world=2, shards=2, env_init=True), world=2, shards=2, tmp_path=tmp_path)


def test_four_process_cluster_by_arguments(tmp_path):
    _check(_cluster(tmp_path, world=4, shards=1, env_init=False), world=4, shards=1, tmp_path=tmp_path)


if __name__ == "__main__":
    if len(sys.argv) < 7 or sys.argv[1] != "worker":
        raise SystemExit(__doc__)
    run_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]), sys.argv[6],
               sys.argv[7:] == ["env"])
