"""The plain reference against the port on the CPU at a small size: the same
weights and rows give the same log-mels, latents, reconstructions and
radial decisions. The port is imported here only to be compared with; the
reference itself imports nothing of it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference import encoder as ref_encoder, mel as ref_mel, radial as ref_radial
from perfbench.reference.audio import rms_normalize
from perfbench.reference.lowp import fp8, tf32

CONFIGS = ["vae-stride", "vae-avgpool"]


def config(name):
    cfg = harness.load_json(harness.PB / "configs" / f"{name}.json")
    cfg["input_hw"] = [cfg["mel"]["target_frames"], cfg["mel"]["n_mels"]]
    return cfg


def vae_config(cfg):
    from anuraxla_torch.models.vae import VAEConfig

    return VAEConfig(latent_dim=cfg["latent_dim"], widths=tuple(cfg["widths"]), dense_width=cfg["dense_width"],
                     groups=cfg["groups"], input_hw=tuple(cfg["input_hw"]), downsample=cfg["downsample"],
                     conv_padding=cfg["conv_padding"], gn_eps=cfg["gn_eps"])


@pytest.mark.parametrize("name", CONFIGS)
def test_encoder_matches_port(name):
    from anuraxla_torch.models.vae import ConvVAEEncoder

    cfg = config(name)
    p = ref_encoder.make_params(cfg, 3, torch.device("cpu"))
    enc = ConvVAEEncoder(vae_config(cfg))
    enc.load_state_dict(p)
    x = torch.randn(3, *cfg["input_hw"], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = enc(x[..., None])
        b = ref_encoder.encode(p, x, cfg)
    for k in ("mu", "logvar"):
        assert torch.allclose(a[k], b[k], rtol=1e-5, atol=1e-5), float((a[k] - b[k]).abs().max())


def test_decoder_matches_port():
    from anuraxla_torch.models.vae import ConvVAE

    cfg = config("vae-stride")
    p = ref_encoder.make_params(cfg, 4, torch.device("cpu"), decoder=True)
    vae = ConvVAE(vae_config(cfg))
    vae.load_state_dict(p)
    z = torch.randn(2, cfg["latent_dim"], generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        a = vae.decoder(z)[..., 0]
    b = ref_encoder.decode(p, z, cfg)
    assert a.shape == b.shape and torch.allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("normalize", [False, True])
def test_log_mel_matches_port(normalize):
    from anuraxla_torch.constants import MelConfig
    from anuraxla_torch.ops.frontend import log_mel_batch, rms_normalize_batch
    from anuraxla_torch.ops.mel import mel_filterbank

    cfg = config("vae-stride")
    m = cfg["mel"]
    assert np.array_equal(ref_mel.filterbank(m["sr"], m["n_fft"], m["n_mels"], m["fmin"], m["fmax"]),
                          mel_filterbank(m["sr"], m["n_fft"], m["n_mels"], m["fmin"], m["fmax"]))
    y = 0.1 * torch.randn(2, int(m["sr"] * m["duration"]), generator=torch.Generator().manual_seed(3))
    y[1] *= 1e-5  # a row under the silence gate passes through unscaled
    ours = rms_normalize(y, cfg["rms"]) if normalize else y
    theirs = rms_normalize_batch(y)[0] if normalize else y
    assert torch.equal(ours, theirs)
    a = log_mel_batch(theirs, MelConfig(**m), parity=True, backend="matmul")
    b = ref_mel.log_mel(ours, m, cfg["standardize_eps"])
    # an FFT against the port's dense DFT: f32 sums in another order, felt most
    # by bins near the 80 dB floor, a few 1e-5 of the standardized range
    assert torch.allclose(a, b, rtol=0, atol=5e-4), float((a - b).abs().max())


def test_radial_decide_matches_port():
    from anuraxla_torch.detect.radial import radial_decide

    g = np.random.default_rng(5)
    Z = g.standard_normal((64, 8)).astype(np.float32)
    cents = g.standard_normal((4, 8)).astype(np.float32)
    thr = np.full(4, 3.6, np.float32)
    det, win, best = radial_decide(torch.from_numpy(Z), torch.from_numpy(cents), torch.from_numpy(thr),
                                   torch.arange(4, dtype=torch.float32))
    det_r, win_r, best_r = ref_radial.decide(ref_radial.distances(torch.from_numpy(Z), cents), thr)
    assert 0 < det_r.sum() < det_r.size
    assert np.array_equal(det.numpy(), det_r) and np.array_equal(win.numpy(), win_r)
    assert np.allclose(best.numpy(), best_r, rtol=1e-6)


def test_roundings():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0e-3, 0.0])
    assert torch.equal(tf32(x)[:3], torch.tensor([1.0, 1.0, 1.0 + 2 ** -9]))  # ties to even
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    rel = ((fp8(y) - y).abs() / y.abs().clamp(min=1e-3)).median()
    assert 0.005 < float(rel) < 0.07  # 3 mantissa bits
