"""The port's soundscape path held against the JAX package on the CPU:
``WavStream`` and ``fleet_window_batches`` bit for bit (PCM16, float32,
stereo, a 44.1 kHz source resampled, the pre-padded layout, the int16
passthrough, host RMS normalization), ``write_detections_csv`` byte for
byte, the span route (``fleet_span_batches`` expanded by
``window_expand_plain``) bit for bit the host route's rows and where it
engages, and the ``scan-soundscape --root`` CLI against the JAX package's
``scan_soundscapes`` on two recordings with planted calls: per-window
decisions identical, scores within the latents' tolerance (rtol 5e-4 / atol
2e-5, ``tests/test_torch_fit.py``), the same ``--extract-dir`` files. The
port's scan normalizes inside the mel op (``normalize_on_device``), the JAX
package's on the host, so the comparison also holds the fused normalization
to the host one."""

import csv
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from anuraxla.constants import MelConfig as JMel
from anuraxla.models.checkpoint import save_encoder as j_save_encoder
from anuraxla.models.vae import VAEConfig as JVAEConfig
from anuraxla.models.vae import init_encoder as j_init_encoder
from anuraxla.pipeline import fit as j_fit
from anuraxla.pipeline import stream as j_stream
from anuraxla.pipeline.session import EncoderSession as JSession
from anuraxla.utils import wavio as j_wavio
from anuraxla_torch.cli import scan_soundscape as t_scan_cli
from anuraxla_torch.constants import MelConfig
from anuraxla_torch.ops.mel_kernel import phase_padded_layout
from anuraxla_torch.ops.window_expand import slot_size, split_slot, window_expand_plain
from anuraxla_torch.parallel import mesh as t_mesh
from anuraxla_torch.pipeline import stream as t_stream
from anuraxla_torch.pipeline.session import EncoderSession, HostRing
from anuraxla_torch.utils import timing
from anuraxla_torch.utils import wavio as t_wavio

SPECIES = ["Batrachyla_leptopus", "Batrachyla_taeniata", "Calyptocephalella_gayi", "Pleurodema_thaul"]
SR = 16000
SMALL = dict(sr=SR, duration=0.5, n_mels=32, fmin=100.0, fmax=7500.0, hop_length=128, n_fft=256, target_frames=48)
MEL_ARGS = ["--sr", "16000", "--n-mels", "32", "--target-frames", "48", "--fmin", "100", "--fmax", "7500",
            "--hop-length", "128", "--n-fft", "256"]
NARROW = dict(latent_dim=8, widths=(8, 16), dense_width=32, groups=4, input_hw=(48, 32))
LATENT_TOL = dict(rtol=5e-4, atol=2e-5)


def _write(path: Path, y: np.ndarray, sr: int, subtype: str) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    t_wavio.write_wav(path, y, sr, subtype=subtype)
    return path


ENCODINGS = {  # name -> (channels, sr, subtype)
    "pcm16": (1, SR, "PCM_16"),
    "float32": (1, SR, "FLOAT"),
    "stereo_pcm16": (2, SR, "PCM_16"),
    "stereo_float32": (2, SR, "FLOAT"),
    "pcm16_44k1": (1, 44100, "PCM_16"),
}


@pytest.mark.parametrize("encoding", list(ENCODINGS))
def test_wavstream_matches_jax(tmp_path, encoding):
    ch, sr, subtype = ENCODINGS[encoding]
    rng = np.random.default_rng(1)
    y = (0.3 * rng.standard_normal((sr * 2 + 123, ch))).astype(np.float32)
    p = _write(tmp_path / "x.wav", y if ch > 1 else y[:, 0], sr, subtype)
    t, j = t_wavio.WavStream(p), j_wavio.WavStream(p)
    for attr in ("sr", "channels", "bits", "format", "num_frames", "duration_seconds", "is_pcm16_mono"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for start, n in ((0, 1000), (777, 4096), (t.num_frames - 100, 400), (-5, 50), (t.num_frames + 10, 8)):
        a, b = t.read(start, n), j.read(start, n)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
        if t.is_pcm16_mono:
            a, b = t.read_i16(start, n), j.read_i16(start, n)
            assert a.dtype == b.dtype and np.array_equal(a, b)
            assert np.array_equal(t.read_i16(start, n).astype(np.float32) / 32768, t.read(start, n))
    if not t.is_pcm16_mono:
        with pytest.raises(ValueError):
            t.read_i16(0, 10)
    garbage = tmp_path / "bad.wav"
    garbage.write_bytes(b"nope")
    with pytest.raises(ValueError):
        t_wavio.WavStream(garbage)


FLEET_CASES = {  # name -> (encodings of the recordings, fleet_window_batches kwargs)
    "pcm16": (["pcm16", "pcm16", "pcm16"], {}),
    "float32": (["float32", "float32"], {}),
    "stereo": (["stereo_pcm16", "stereo_float32"], {}),
    "resampled_44k1": (["pcm16_44k1", "pcm16"], {}),
    "layout": (["pcm16", "float32"], {"layout": True}),
    "int16_passthrough": (["pcm16", "pcm16"], {"emit_int16": True}),
    "int16_refused_for_float": (["pcm16", "float32"], {"emit_int16": True}),
    "host_normalize": (["pcm16", "stereo_float32"], {"normalize": True}),
    "no_prefetch": (["pcm16", "pcm16"], {"prefetch": False}),
}


@pytest.mark.parametrize("case", list(FLEET_CASES))
def test_fleet_window_batches_match_jax(tmp_path, case):
    encodings, kw = FLEET_CASES[case]
    rng = np.random.default_rng(2)
    paths = []
    for i, enc in enumerate(encodings):
        ch, sr, subtype = ENCODINGS[enc]
        n = int(sr * (1.3 + 0.45 * i))
        y = (0.2 * rng.standard_normal((n, ch))).astype(np.float32)
        y[: n // 3] *= 0.001 if i == 0 else 1.0  # a quiet stretch: windows below the RMS gate
        paths.append(_write(tmp_path / f"r{i}.wav", y if ch > 1 else y[:, 0], sr, subtype))
    mel = MelConfig(**SMALL)
    kw = dict(kw)
    if kw.pop("layout", False):
        kw["layout"] = phase_padded_layout(mel, mel.total_frames)
    args = dict(num_samples=mel.num_samples, hop_samples=3000, batch_size=4, target_sr=SR, **kw)
    got = list(t_stream.fleet_window_batches([t_wavio.WavStream(p) for p in paths], **args))
    want = list(j_stream.fleet_window_batches([j_wavio.WavStream(p) for p in paths], **args))
    assert len(got) == len(want) > 2
    for (b, tags, nv), (jb, jtags, jnv) in zip(got, want):
        assert b.dtype == jb.dtype and np.array_equal(b, jb) and np.array_equal(tags, jtags) and nv == jnv
    assert got[0][0].dtype == (np.int16 if case == "int16_passthrough" else np.float32)
    if case == "layout":
        row_len, off = kw["layout"]
        assert got[0][0].shape[1] == row_len and not got[0][0][:, :off].any()
    # the single-recording wrapper
    one = list(t_stream.window_batches(t_wavio.WavStream(paths[-1]), **{k: v for k, v in args.items()
                                                                      if k != "emit_int16"}))
    jone = list(j_stream.window_batches(j_wavio.WavStream(paths[-1]), **{k: v for k, v in args.items()
                                                                       if k != "emit_int16"}))
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2] for a, b in zip(one, jone))


SPAN_CASES = {  # name -> (recording lengths in samples, hop, batch size, pre-padded layout)
    # batches cross file boundaries, each file's last window runs past EOF, the last batch is partial
    "file_boundary": ([20000, 37000, 15000], 3000, 4, False),
    "short_file": ([5000, 23000, 700], 2000, 3, False),  # whole files shorter than a window
    "hop_longer_than_window": ([41000, 30000], 9000, 4, False),  # a run a window
    "layout": ([26000, 17000], 4000, 5, True),
}


@pytest.mark.parametrize("case", list(SPAN_CASES))
def test_span_rows_match_host_rows(tmp_path, case):
    """The rows the span route's slots expand to (the plain twin) are the host
    route's rows bit for bit, with the same tags and n_valid."""
    lengths, hop, B, padded = SPAN_CASES[case]
    rng = np.random.default_rng(7)
    paths = [_write(tmp_path / f"r{i}.wav", (0.3 * rng.standard_normal(n)).astype(np.float32), SR, "PCM_16")
             for i, n in enumerate(lengths)]
    mel = MelConfig(**SMALL)
    L = mel.num_samples
    layout = phase_padded_layout(mel, mel.total_frames) if padded else None
    row_len, col = layout or (L, 0)
    ring = HostRing((slot_size(B, B * L),), torch.int16, torch.device("cpu"))
    got = []
    for spans, tags, nv in t_stream.fleet_span_batches([t_wavio.WavStream(p) for p in paths], num_samples=L,
                                                      hop_samples=hop, batch_size=B, ring=ring):
        slot = spans.ring.send(spans.k, 0, spans.n)  # expanded before the ring comes round
        table, runs = split_slot(slot, B)
        got.append((window_expand_plain(slot, B, L, row_len, col).numpy(), tags, nv, table[:, 1].tolist(),
                    runs.numel()))
    want = list(t_stream.fleet_window_batches([t_wavio.WavStream(p) for p in paths], num_samples=L,
                                              hop_samples=hop, batch_size=B, target_sr=SR, layout=layout))
    assert len(got) == len(want) > 1
    for (rows, tags, nv, lens, samples), (wrows, wtags, wnv) in zip(got, want):
        assert rows.dtype == wrows.dtype == np.float32 and rows.shape == (B, row_len)
        assert np.array_equal(rows, wrows) and np.array_equal(tags, wtags) and nv == wnv
        assert lens[nv:] == [0] * (B - nv) and samples <= sum(lens) <= B * L
        assert hop < L or samples == sum(lens)
    assert got[-1][2] < B  # a partial last batch
    assert any(min(g[3][: g[2]]) < L for g in got)  # a window past EOF
    if case == "file_boundary":
        assert any(len(set(g[1][: g[2], 0])) > 1 for g in got)
        assert any(g[4] < sum(g[3]) for g in got)  # overlapping windows share their samples
    if padded:
        assert col > 0 and not got[0][0][:, :col].any()


def _write_pcm32(path: Path, y: np.ndarray, sr: int) -> Path:
    """A mono PCM32 WAV (``write_wav`` writes PCM16 and float alone)."""
    data = np.clip(np.round(y * 2147483648.0), -2147483648, 2147483647).astype("<i4").tobytes()
    head = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE", b"fmt ", 16, 1, 1, sr, 4 * sr, 4, 32,
                       b"data", len(data))
    path.write_bytes(head + data)
    return path


ROUTE_CASES = {  # name -> (recording kind, session kwargs, scan's normalize, the span route engages)
    "pcm16_device_rms": ("pcm16", {"normalize_on_device": True}, True, True),
    "pcm16_no_normalize": ("pcm16", {}, False, True),
    "pcm16_int16_link": ("pcm16", {"normalize_on_device": True, "transfer_int16": True}, True, True),
    "resampled": ("pcm16_44k1", {"normalize_on_device": True}, True, False),
    "stereo": ("stereo_pcm16", {"normalize_on_device": True}, True, False),
    "pcm32": ("pcm32", {"normalize_on_device": True}, True, False),
    "host_normalize": ("pcm16", {}, True, False),
    "data_parallel": ("pcm16", {"normalize_on_device": True, "data_parallel": True}, True, False),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_span_route_engages(project, tmp_path, case):
    """The scan cuts its windows on the device (``windows_on_device``, the
    ``extract`` spans' ``on_device``) for PCM16 mono at the mel rate, and not
    for a resampled, stereo or PCM32 fleet, host normalization or a
    data-parallel session."""
    root, _ = project
    kind, extra, normalize, engages = ROUTE_CASES[case]
    rng = np.random.default_rng(8)
    paths = []
    for i in range(2):
        sr = 44100 if kind == "pcm16_44k1" else SR
        y = (0.2 * rng.standard_normal((int(sr * (1.6 + 0.5 * i)), 2 if kind == "stereo_pcm16" else 1)))
        y = y.astype(np.float32)[:, 0] if kind != "stereo_pcm16" else y.astype(np.float32)
        p = tmp_path / f"r{i}.wav"
        paths.append(_write_pcm32(p, y, sr) if kind == "pcm32" else _write(p, y, sr, "PCM_16"))
    cfg = json.loads((root / "config.json").read_text())
    if extra.get("data_parallel"):
        t_mesh.set_default_devices(["cpu"] * 2)
    try:
        sess = EncoderSession(mel=MelConfig(**SMALL), backend="matmul", project_root=root, batch_size=4,
                              device="cpu", **extra).load()
        assert (sess._mesh is not None) == bool(extra.get("data_parallel"))
        if sess._mesh is not None:  # the session itself refuses spans it would expand on one device
            spans = next(iter(t_stream.fleet_span_batches(
                [t_wavio.WavStream(p) for p in paths], num_samples=sess.mel.num_samples, hop_samples=SR // 4,
                batch_size=4, ring=sess.span_ring())))[0]
            with pytest.raises(ValueError, match="data shards"):
                sess._dispatch(spans)
        timing.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            _, stats = t_stream.scan_soundscapes(paths, sess, detector="radial", config=cfg, hop_seconds=0.25,
                                                 normalize=normalize, log=lambda *a: None)
        recs = [r for r in timing.spans() if r.name == "extract"]
    finally:
        t_mesh.set_default_devices(None)
        timing.clear_spans()
    assert stats["n_windows"] == 7 + 9 and len(recs) == 4  # batches of 4, one across the file boundary
    assert stats["windows_on_device"] == (stats["n_windows"] if engages else 0)
    assert [r.counts["on_device"] for r in recs] == [int(engages)] * 4
    assert sum(r.counts["windows"] for r in recs) == stats["n_windows"]
    if engages:  # overlapping windows: each source sample copied once
        assert all(r.counts["samples"] < r.counts["windows"] * sess.mel.num_samples for r in recs)


def test_detections_csv_is_the_references(tmp_path):
    rng = np.random.default_rng(3)
    rows = [(0.5 * i, 0.5 * i + 0.5, bool(rng.random() > 0.5), float(rng.standard_normal())) for i in range(12)]
    for mod, name in ((t_stream, "t.csv"), (j_stream, "j.csv")):
        dets = [mod.Detection(t0, t1, d, SPECIES[i % 4] if d else None, s) for i, (t0, t1, d, s) in enumerate(rows)]
        mod.write_detections_csv(dets, tmp_path / name, "best_distance")
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def _tone(rng, k, n):
    """Species k's call: a tone (its centre jittered) plus noise."""
    t = np.arange(n) / SR
    f = 700 + 1800 * k + 60 * rng.standard_normal()
    return 0.3 * np.sin(2 * np.pi * f * t) + 0.003 * rng.standard_normal(n)


# (site, {species index: (first second, last second)}) of each 20 s recording
PLANTED = {"siteA": {0: (4, 6), 2: (12, 14)}, "siteB": {1: (8, 10), 3: (15, 17)}}


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """A project root with the default encoder artifact (written by the JAX
    package), a config.json with a radial block fitted by the JAX package on
    a 4-species tree, and two 20 s recordings, both named rec.wav (siteA/,
    siteB/), noise with planted calls; also a pre-normalized copy of each.
    -> (root, the JAX package's session on it)."""
    root = tmp_path_factory.mktemp("scanproject")
    rng = np.random.default_rng(4)
    n = SR // 2
    for k, sp in enumerate(SPECIES):
        for i in range(10):
            _write(root / "chunks" / sp / f"c{i:02d}.wav", _tone(rng, k, n).astype(np.float32), SR, "PCM_16")
    for site, calls in PLANTED.items():
        y = 0.01 * rng.standard_normal(20 * SR)
        for k, (a, b) in calls.items():  # one chunk-like call for each 0.5 s window
            y[a * SR : b * SR] = np.concatenate([_tone(rng, k, n) for _ in range(2 * (b - a))])
        _write(root / "recs" / site / "rec.wav", y.astype(np.float32), SR, "PCM_16")
        _write(root / "recs_norm" / site / "rec.wav", (y * 0.05 / np.sqrt(np.mean(y * y))).astype(np.float32), SR,
               "PCM_16")
    jcfg = JVAEConfig(**NARROW)
    _, params = j_init_encoder(jcfg, seed=6)
    j_save_encoder(root / "models" / "anuraxla_vae_encoder_v0", jcfg, params)
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps({"species": SPECIES, "chunk_seconds": 0.5}))
    js = JSession(mel=JMel(**SMALL), backend="matmul", project_root=root, batch_size=16).load()
    j_fit.fit_radial_tree(cfg_path=cfg_path, cfg=json.loads(cfg_path.read_text()), chunks_dir=root / "chunks",
                          session=js, q_in=0.95, q_out=0.1, cache=False, cache_dir=None, max_per_class=0, seed=1,
                          log=lambda *a: None)
    return root, js


def _read(path):
    with open(path, newline="", encoding="utf-8") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("normalize", [True, False])
def test_scan_soundscape_fleet_matches_jax(project, tmp_path, monkeypatch, capsys, normalize):
    """scan-soundscape --root over both recordings (hop 0.5 s, windows of
    both files sharing batches of 16): with on-device RMS against the JAX
    package's host RMS, and with --no-normalize on pre-normalized audio."""
    root, js = project
    monkeypatch.chdir(root)
    recs = root / ("recs" if normalize else "recs_norm")
    argv = ["--root", str(recs), "--hop-seconds", "0.5", "--out", str(tmp_path / "out"), "--extract-dir",
            str(tmp_path / "t_ext"), "--device", "cpu", "--frontend-backend", "matmul", "--batch-size", "16",
            *MEL_ARGS] + ([] if normalize else ["--no-normalize"])
    scans = []

    def scan(*a, **k):
        per_file, stats = t_stream.scan_soundscapes(*a, **k)
        scans.append(stats)
        return per_file, stats

    monkeypatch.setattr(t_scan_cli, "scan_soundscapes", scan)
    t_scan_cli.main(argv)
    out = capsys.readouterr().out
    assert "fleet scan: 2 recordings" in out
    # PCM16 mono at the mel rate, no host normalization: the windows are cut from source spans
    assert [s["windows_on_device"] for s in scans] == [s["n_windows"] for s in scans] == [80]
    cfg = json.loads((root / "config.json").read_text())
    wavs = sorted(recs.rglob("*.wav"))
    want, stats = j_stream.scan_soundscapes(wavs, js, detector="radial", config=cfg, hop_seconds=0.5,
                                            normalize=normalize, log=lambda *a: None)
    assert stats["n_windows"] == 2 * 40
    for wav in wavs:
        key = "__".join(wav.relative_to(recs).with_suffix("").parts)  # siteA__rec: no clobbering
        rows = _read(tmp_path / "out" / f"{key}.detections.csv")
        jd = want[wav]
        assert [(r["t_start"], r["t_end"], r["detected"], r["species"]) for r in rows] == \
               [(f"{d.t_start:.3f}", f"{d.t_end:.3f}", str(d.detected), d.species or "NO_DETECT") for d in jd]
        np.testing.assert_allclose([float(r["best_distance"]) for r in rows], [d.score for d in jd], **LATENT_TOL)
        j_stream.extract_detected_chunks(wav, jd, tmp_path / "j_ext", sr=SR, stem=key, log=lambda *a: None)
        # windows inside a planted call are detected as that call's species
        for k, (a, b) in PLANTED[wav.parent.name].items():
            inside = [r["species"] for r in rows if a <= float(r["t_start"]) and float(r["t_end"]) <= b]
            assert inside.count(SPECIES[k]) >= len(inside) // 2, (wav, k, inside)
    t_files = sorted(p.relative_to(tmp_path / "t_ext") for p in (tmp_path / "t_ext").rglob("*.wav"))
    j_files = sorted(p.relative_to(tmp_path / "j_ext") for p in (tmp_path / "j_ext").rglob("*.wav"))
    assert t_files == j_files and len(t_files) >= 4
    assert {f.parts[1].split("_t")[0] for f in t_files} == {"siteA__rec", "siteB__rec"}
    assert all((tmp_path / "t_ext" / f).read_bytes() == (tmp_path / "j_ext" / f).read_bytes() for f in t_files)


def test_scan_paths_agree_and_refuse(project):
    """The port's scan: host normalization, the fused one and the int16 link
    decide alike; a noised session and normalize=False on a fused session are
    refused."""
    root, _ = project
    cfg = json.loads((root / "config.json").read_text())
    wavs = sorted((root / "recs").rglob("*.wav"))
    kw = dict(mel=MelConfig(**SMALL), backend="matmul", project_root=root, batch_size=16, device="cpu")
    runs = {}
    for name, extra in (("host", {}), ("fused", {"normalize_on_device": True}),
                        ("fused_int16", {"normalize_on_device": True, "transfer_int16": True})):
        sess = EncoderSession(**kw, **extra).load()
        per_file, _ = t_stream.scan_soundscapes(wavs, sess, detector="radial", config=cfg, hop_seconds=0.5,
                                                log=lambda *a: None)
        runs[name] = [(d.t_start, d.species, d.score) for w in wavs for d in per_file[w]]
    for name in ("fused", "fused_int16"):
        assert [r[:2] for r in runs[name]] == [r[:2] for r in runs["host"]]
        np.testing.assert_allclose([r[2] for r in runs[name]], [r[2] for r in runs["host"]], **LATENT_TOL)
    assert runs["fused_int16"] == runs["fused"]  # PCM16 sources: the int16 link carries the same samples
    one = t_stream.scan_soundscape(wavs[0], EncoderSession(**kw).load(), detector="radial", config=cfg,
                                   hop_seconds=0.5, log=lambda *a: None)
    assert [(d.t_start, d.species) for d in one] == [r[:2] for r in runs["host"][:40]]
    with pytest.raises(ValueError, match="add_noise_db"):
        t_stream.scan_soundscapes(wavs, EncoderSession(**kw, add_noise_db=10.0).load(), detector="radial",
                                  config=cfg)
    with pytest.raises(ValueError, match="normalize_on_device"):
        t_stream.scan_soundscapes(wavs, EncoderSession(**kw, normalize_on_device=True).load(), detector="radial",
                                  config=cfg, normalize=False)
    with pytest.raises(SystemExit, match="exactly one"):
        t_scan_cli.main(["--wav", str(wavs[0]), "--root", str(root / "recs"), "--config", str(root / "config.json"),
                         "--device", "cpu"])
