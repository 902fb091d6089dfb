"""The port's Hopper kernel and its wrapper on the card: kernel against its
plain PyTorch version (2e-5 of each row's max, the exact tier's bound), launch
counting, the wrapper's refusals on a CUDA tensor, and the session on the
card against the same session on the CPU.

These tests need an NVIDIA card and ``nvcc``; elsewhere they skip. The
card's machine has no JAX, so this file imports none and runs without the
test suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from anuraxla_torch.constants import DEFAULT_MEL, MelConfig
from anuraxla_torch.ops import frontend as tfe
from anuraxla_torch.ops import mel_kernel as tk
from anuraxla_torch.pipeline.session import EncoderSession

pytestmark = pytest.mark.cuda

SMALL = dict(sr=16000, duration=0.5, n_mels=32, fmin=100.0, fmax=7500.0,
             hop_length=128, n_fft=256, target_frames=48)
R16 = dict(sr=48000, duration=1.0, n_mels=64, fmin=150.0, fmax=15000.0,
           hop_length=384, n_fft=2048, target_frames=64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card's machine)")
    return torch.device("cuda")


def _rows(cfg, B, seed):
    """[B, num_samples] rows: row 0 silent, row 1 clips after RMS scaling."""
    rng = np.random.default_rng(seed)
    y = (0.1 * rng.standard_normal((B, cfg.num_samples))).astype(np.float32)
    y[0] = 1e-7 * rng.standard_normal(cfg.num_samples)
    y[1] = 0.001 * rng.standard_normal(cfg.num_samples)
    y[1, :: cfg.num_samples // 5] = 0.9
    return y


@pytest.mark.parametrize("cfg", [SMALL, R16, dict(R16, hop_length=512, n_fft=1024)], ids=["small", "r16", "r8"])
@pytest.mark.parametrize("pre_padded", [True, False])
def test_kernel_matches_plain(card, cfg, pre_padded):
    cfg = MelConfig(**cfg)
    y = _rows(cfg, 3, seed=1)
    T = cfg.total_frames
    if pre_padded:
        L_pad, off = tk.phase_padded_layout(cfg, T)
        yp = np.zeros((3, L_pad), np.float32)
        yp[:, off : off + cfg.num_samples] = y
        y = yp
    x = torch.from_numpy(y).to(card)
    s = tfe.rms_scale_batch(torch.from_numpy(_rows(cfg, 3, seed=1)).to(card))
    assert float(s[0]) == -1.0 and float(s[1]) > 0
    n0 = tk.mel_power.launches
    got = tk.mel_power(x, cfg, num_frames=T, rms_scale=s, pre_padded=pre_padded)
    assert tk.mel_power.launches == n0 + 1
    if not pre_padded:
        x = torch.nn.functional.pad(x, (cfg.n_fft // 2, cfg.n_fft // 2))
    ref = tk.mel_power_ct_plain(x, s, cfg, T)
    assert got.shape == ref.shape == (3, T, cfg.n_mels) and got.device.type == "cuda"
    # each row against its own max: the silent row's power is ~1e-12 of the others'
    rel = (got - ref).abs().amax(dim=(1, 2)) / ref.abs().amax(dim=(1, 2))
    assert float(rel.max()) <= 2e-5, rel


def test_wrapper_refuses_on_cuda(card):
    x = torch.zeros((2, 16000), device=card)
    with pytest.raises(NotImplementedError):  # a config the kernel does not take
        tk.mel_power(x, MelConfig(hop_length=160), num_frames=10)
    cfg = MelConfig(**SMALL)
    T = cfg.total_frames
    y = torch.zeros((2, cfg.num_samples), device=card)
    with pytest.raises(ValueError):
        tk.mel_power(y.double(), cfg, num_frames=T)
    L_pad, _ = tk.phase_padded_layout(cfg, T)
    with pytest.raises(ValueError):  # pre-padded rows go to the kernel as given
        tk.mel_power(torch.zeros((L_pad, 2), device=card).t(), cfg, num_frames=T, pre_padded=True)
    with pytest.raises(ValueError):  # scale on another device
        tk.mel_power(y, cfg, num_frames=T, rms_scale=torch.ones(2))
    # only the config gate carries over: "cuda" resolves to the matmul
    # frontend for a config the kernel does not take, and launches nothing
    n0 = tk.mel_power.launches
    other = MelConfig(sr=16000, duration=0.5, hop_length=160, n_fft=400, n_mels=32, target_frames=48)
    out = tfe.log_mel_batch(torch.zeros((2, other.num_samples), device=card), other, backend="cuda")
    assert out.shape == (2, 48, 32) and tk.mel_power.launches == n0


def test_session_on_card_matches_cpu(card):
    cfg = DEFAULT_MEL.replace(duration=1.0)
    rng = np.random.default_rng(2)
    audio = (0.1 * rng.standard_normal((3, cfg.num_samples))).astype(np.float32)
    audio[2] = 0.0
    kw = dict(mel=cfg, normalize_on_device=True, pre_padded_host=True, init_seed=3)
    n0 = tk.mel_power.launches
    Zg = EncoderSession(**kw, device="cuda").load().encode_array(audio)
    assert tk.mel_power.launches > n0
    Zc = EncoderSession(**kw, device="cpu").load().encode_array(audio)
    np.testing.assert_allclose(Zg, Zc, rtol=5e-4, atol=2e-5)
