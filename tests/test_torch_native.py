"""The port's host side held against the JAX package on the CPU: the native
WAV decoder (built with g++ into ``anuraxla_torch/_build``) bitwise against
the reference's native loader and against the port's Python reader; decoding
straight into the session's host ring (pinned buffers on a card, plain
tensors here, the same code path) with noise added in place; the route
counter; and encoder artifacts written by either package loaded by the
other, through the port's own msgpack reader and writer."""

import logging

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from anuraxla.models.checkpoint import load_encoder as j_load_encoder
from anuraxla.models.checkpoint import save_encoder as j_save_encoder
from anuraxla.models.vae import VAEConfig as JVAEConfig
from anuraxla.models.vae import init_encoder as j_init_encoder
from anuraxla.native import wavloader as j_wavloader
from anuraxla.pipeline.dataset import load_wav_batch as j_load_wav_batch
from anuraxla.pipeline.session import EncoderSession as JSession
from anuraxla_torch.constants import DEFAULT_MEL, MelConfig
from anuraxla_torch.models import checkpoint as t_ckpt
from anuraxla_torch.models.convert import encoder_state_from_jax
from anuraxla_torch.models.vae import ConvVAEEncoder, VAEConfig
from anuraxla_torch.native import wavloader
from anuraxla_torch.ops.mel_kernel import phase_padded_layout
from anuraxla_torch.pipeline import dataset as t_dataset
from anuraxla_torch.pipeline.session import EncoderSession, HostRing, to_pcm16
from anuraxla_torch.utils import msgpack_codec
from anuraxla_torch.utils.wavio import write_wav

SMALL = MelConfig(sr=16000, duration=0.5, hop_length=128, n_fft=256, n_mels=32, target_frames=48)
NARROW = dict(latent_dim=8, widths=(8, 16), dense_width=32, groups=4, input_hw=(48, 32))


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """PCM16 at the target rate (the served format), stereo, float, a short
    file, a file at another rate (resampled), a corrupt and a missing one."""
    d = tmp_path_factory.mktemp("native_wavs")
    rng = np.random.default_rng(40)
    n = SMALL.num_samples
    y = (0.2 * rng.standard_normal((4, n))).astype(np.float32)
    paths = []
    for i in range(3):
        paths.append(d / f"pcm16_{i}.wav")
        write_wav(paths[-1], y[i], SMALL.sr)
    paths.append(d / "stereo.wav")
    write_wav(paths[-1], np.stack([y[3], -0.5 * y[3]], axis=1), SMALL.sr)
    paths.append(d / "float.wav")
    write_wav(paths[-1], y[0], SMALL.sr, subtype="FLOAT")
    paths.append(d / "short.wav")
    write_wav(paths[-1], y[1, :1000], SMALL.sr)
    paths.append(d / "rate22050.wav")
    write_wav(paths[-1], y[2, :11025], 22050)
    paths.append(d / "corrupt.wav")
    paths[-1].write_bytes(b"not a wav")
    paths.append(d / "missing.wav")
    return paths


def test_native_decoder_matches_reference_native_and_python_reader(wavs):
    assert wavloader.available() and j_wavloader.available()
    layout = phase_padded_layout(SMALL, SMALL.total_frames)
    for lay in (None, layout):
        kw = dict(sr=SMALL.sr, num_samples=SMALL.num_samples, layout=lay)
        before = dict(t_dataset.load_wav_batch.routes)
        nat = t_dataset.load_wav_batch(wavs, **kw)
        assert t_dataset.load_wav_batch.routes["native"] == before["native"] + 1
        ref = j_wavloader.load_batch(wavs, **kw)
        py = t_dataset.load_wav_batch(wavs, use_native=False, **kw)
        assert t_dataset.load_wav_batch.routes["python"] == before["python"] + 1
        assert nat.ok.tolist() == ref.ok.tolist() == py.ok.tolist() == [True] * 7 + [False, False]
        assert all(e for e in nat.errors[7:]) and nat.errors[:7] == [None] * 7
        # the same C++ source: bitwise the reference's native loader on every row
        assert np.array_equal(nat.audio, ref.audio)
        # and bitwise the Python reader on the rows it decodes without resampling
        assert np.array_equal(nat.audio[:6], py.audio[:6])
        np.testing.assert_allclose(nat.audio[6], py.audio[6], atol=5e-6)  # polyphase resample, as tests/test_native.py
        assert np.array_equal(py.audio, j_load_wav_batch(wavs, use_native=False, **kw).audio)
        if lay is not None:
            off = lay[1]
            assert not nat.audio[:, :off].any() and not nat.audio[:, off + SMALL.num_samples :].any()


def test_decode_into_host_ring_matches_reference(wavs):
    """``encode_paths``' route: each batch decoded straight into a slot of the
    session's host ring (plain tensors on the CPU, pinned on a card), in the
    pre-padded layout, the last batch's spare rows zeroed, noise added in
    place with the reference's per-row seeds."""
    cfg = DEFAULT_MEL.replace(sr=SMALL.sr, duration=SMALL.duration)
    params = {k: torch.zeros_like(v) for k, v in ConvVAEEncoder(VAEConfig(input_hw=(192, 64))).state_dict().items()}
    kw = dict(mel=cfg, device="cpu", batch_size=4, pre_padded_host=True)
    sess = EncoderSession(**kw).load(params)
    noisy = EncoderSession(**kw, add_noise_db=3.0, noise_seed=5).load(params)
    layout = sess._layout
    ref = j_wavloader.load_batch(wavs, sr=cfg.sr, num_samples=cfg.num_samples, layout=layout)
    jn = JSession(mel=DEFAULT_MEL.replace(sr=SMALL.sr, duration=SMALL.duration), add_noise_db=3.0, noise_seed=5)
    jn._layout = layout
    for s, want in ((sess, ref.audio), (noisy, jn._inject_noise(ref.audio, 0, len(wavs)))):
        got, oks = [], []
        for batch, n_valid in s.decoded_batches(wavs):
            assert s._rings[torch.float32].slot_of(batch.audio) is not None and batch.audio.shape == (4, layout[0])
            assert not batch.audio[n_valid:].any()  # the last batch's spare rows
            got.append(batch.audio[:n_valid].copy())
            oks += batch.ok[:n_valid].tolist()
        assert oks == ref.ok.tolist()
        assert np.array_equal(np.concatenate(got), want)
    assert not np.array_equal(ref.audio, want)


def test_host_ring_hands_out_slots_in_turn():
    ring = HostRing((2, 5), torch.int16, torch.device("cpu"))  # three slots
    views = [ring.claim() for _ in range(4)]
    assert views[3] is views[0] and len({id(v) for v in views[:3]}) == 3
    views[1][...] = 7
    t = ring.send(ring.slot_of(views[1]))
    assert t.dtype == torch.int16 and int(t.sum()) == 70 and ring.slot_of(views[1]) == 1
    assert int(ring.send(1, 1, 2).sum()) == 35
    assert ring.slot_of(views[1].copy()) is None


def test_to_pcm16_is_the_reference_conversion():
    """The reference's clip(round(y * 32768)) -> int16, ties to even, into a
    strided window; 37 rows, so the last block is partial."""
    a = (0.6 * np.random.default_rng(41).standard_normal((37, 1000))).astype(np.float32)
    a[0, :7] = [0.5 / 32768, 1.5 / 32768, -2.5 / 32768, 1.0, -1.0, 3.0, -3.0]
    want = np.clip(np.round(a * 32768.0), -32768, 32767).astype(np.int16)
    out = np.zeros((37, 1100), np.int16)
    to_pcm16(a, out[:, 50:1050])
    assert np.array_equal(out[:, 50:1050], want) and not out[:, :50].any() and not out[:, 1050:].any()
    assert want[0, :7].tolist() == [0, 2, -2, 32767, -32768, 32767, -32768]


def test_encode_paths_equals_encode_array(wavs, tmp_path):
    """Decoding into the ring changes no latent: ``encode_paths`` equals
    ``encode_array`` on the reference's decoded rows, f32 and PCM16 transfer."""
    cfg = DEFAULT_MEL.replace(sr=SMALL.sr, duration=SMALL.duration)
    paths = wavs[:4]
    rows = j_wavloader.load_batch(paths, sr=cfg.sr, num_samples=cfg.num_samples).audio
    for kw in (dict(pre_padded_host=True), dict(transfer_int16=True, pre_padded_host=True), dict(add_noise_db=6.0)):
        s = EncoderSession(mel=cfg, device="cpu", batch_size=4, normalize_on_device=True, init_seed=2,
                           project_root=tmp_path, **kw).load()
        Z, ok, _ = s.encode_paths(paths)
        assert ok.all() and np.array_equal(Z, s.encode_array(rows)), kw


def _jax_encoder(seed=3):
    cfg = JVAEConfig(**NARROW)
    _, params = j_init_encoder(cfg, seed=seed)
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def test_jax_artifact_loads_in_the_port(tmp_path):
    jcfg, jparams = _jax_encoder()
    j_save_encoder(tmp_path / "enc", jcfg, jparams)
    state, cfg = t_ckpt.load_encoder(tmp_path / "enc")
    assert cfg == VAEConfig(**NARROW)
    want = encoder_state_from_jax(jparams, cfg)
    assert state.keys() == want.keys() and all(torch.equal(state[k], want[k]) for k in want)
    # served by a session: the latents of the same params given directly
    mel = SMALL
    rows = (0.1 * np.random.default_rng(8).standard_normal((3, mel.num_samples))).astype(np.float32)
    from_artifact = EncoderSession(mel=mel, device="cpu", encoder_dir=tmp_path / "enc").load()
    direct = EncoderSession(mel=mel, device="cpu", encoder_cfg=cfg).load(want)
    assert np.array_equal(from_artifact.encode_array(rows), direct.encode_array(rows))
    # the default artifact under the project root is found without --encoder
    j_save_encoder(tmp_path / "models" / "anuraxla_vae_encoder_v0", jcfg, jparams)
    by_root = EncoderSession(mel=mel, device="cpu", project_root=tmp_path).load()
    assert np.array_equal(by_root.encode_array(rows), direct.encode_array(rows))


def test_port_artifact_loads_in_jax(tmp_path):
    jcfg, jparams = _jax_encoder(seed=4)
    cfg = VAEConfig(**NARROW)
    state = encoder_state_from_jax(jparams, cfg)
    t_ckpt.save_encoder(tmp_path / "enc", cfg, state)
    _, params, cfg_back = j_load_encoder(tmp_path / "enc")
    assert cfg_back == jcfg
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(jparams))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.asarray(leaf).dtype == np.float32 and np.array_equal(np.asarray(leaf), flat_b[path]), path
    # and back through the port: the same state, bitwise
    again, _ = t_ckpt.load_encoder(tmp_path / "enc")
    assert all(torch.equal(again[k], state[k]) for k in state)


def test_msgpack_codec_matches_the_library():
    obj = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, -1, -32, -33, -128, -129,
                 -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [0.0, -1.5, 1e300], "flags": [True, False, None],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
        "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
        "big": {f"k{i}": i for i in range(20)}, "long": list(range(20)),
        "nested": {"a": {"b": [[1, 2], {"c": "d"}]}},
    }
    assert msgpack_codec.packb(obj) == msgpack.packb(obj, use_bin_type=True)
    assert msgpack_codec.unpackb(msgpack.packb(obj, use_bin_type=True)) == obj
    # flax's own bytes of a param tree, and ours read back by flax
    tree = {"params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "s": np.float32(2.5),
                       "i": np.arange(3, dtype=np.int64)}}
    back = msgpack_codec.unpackb(serialization.to_bytes(tree))
    assert np.array_equal(back["params"]["w"], tree["params"]["w"]) and back["params"]["s"] == 2.5
    assert back["params"]["i"].dtype == np.int64
    ours = serialization.msgpack_restore(msgpack_codec.packb(tree))
    assert all(np.array_equal(ours["params"][k], tree["params"][k]) for k in tree["params"])
    with pytest.raises(ValueError):
        msgpack_codec.unpackb(msgpack_codec.packb([1, 2])[:-1])


def test_seeded_init_warns_once(tmp_path, caplog):
    """No artifact and no params: a seeded init, with one warning line that
    says so; an artifact or explicit params: no warning."""
    with caplog.at_level(logging.WARNING, logger="anuraxla_torch.models.checkpoint"):
        EncoderSession(mel=SMALL, device="cpu", encoder_cfg=VAEConfig(**NARROW), project_root=tmp_path).load()
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 1 and "seeded random init" in lines[0] and "\n" not in lines[0]
    caplog.clear()
    jcfg, jparams = _jax_encoder()
    j_save_encoder(tmp_path / "enc", jcfg, jparams)
    with caplog.at_level(logging.WARNING, logger="anuraxla_torch.models.checkpoint"):
        EncoderSession(mel=SMALL, device="cpu", encoder_dir=tmp_path / "enc").load()
    assert not caplog.records
