"""The plain reference against the port on the CPU at a small size: the same
weights and rows give the same log-mels, latents, reconstructions and
radial decisions. Every configuration of BENCHMARK.json is compared through
its encoder family (``perfbench/families/``): the family's weights loaded in
the port's session, and its reference latents. The port is imported here
only to be compared with; the reference itself imports nothing of it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import families, harness
from perfbench.reference import encoder as ref_encoder, mel as ref_mel, radial as ref_radial
from perfbench.reference.audio import rms_normalize
from perfbench.reference.lowp import fp8, tf32

CONFIGS = [c["name"] for c in harness.load_json(harness.ROOT / "BENCHMARK.json")["configs"]]
CONV_VAE = [n for n in CONFIGS if families.name_of(harness.load_config(n)) == "conv-vae"]


def config(name):
    """The configuration as the CPU tests run it: its family's cut."""
    cfg = harness.load_config(name)
    return families.of(cfg).cpu_cut(cfg)


@pytest.mark.parametrize("name", CONFIGS)
def test_encoder_matches_port(name):
    """The family's weights in the port's session, against the family's reference latents."""
    from anuraxla_torch.constants import MelConfig
    from anuraxla_torch.pipeline.session import EncoderSession

    cfg = config(name)
    fam = families.of(cfg)
    p = fam.make_params(cfg, 3, torch.device("cpu"))
    session = EncoderSession(mel=MelConfig(**cfg["mel"]), batch_size=3, encoder_cfg=fam.program_config(cfg),
                             device="cpu").load(params=p)
    x = torch.randn(3, *cfg["input_hw"], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = session._enc(x[..., None])["mu"]
    b = fam.encode(p, x, cfg)
    assert a.shape == b.shape == (3, fam.latent_dim(cfg))
    assert torch.allclose(a, b, rtol=1e-5, atol=1e-5), float((a - b).abs().max())


@pytest.mark.parametrize("name", CONV_VAE)
def test_conv_vae_heads_match_port(name):
    from anuraxla_torch.models.vae import ConvVAEEncoder

    cfg = config(name)
    p = ref_encoder.make_params(cfg, 3, torch.device("cpu"))
    enc = ConvVAEEncoder(families.load("conv-vae").program_config(cfg))
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
    vae = ConvVAE(families.load("conv-vae").program_config(cfg))
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
