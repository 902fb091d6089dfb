"""The int8 kernels' host side on the CPU (``anuraxla_torch/ops/int8.py``):
the packed W the ``wgmma`` path streams, read back into the reference's
layout; the f32-operand mode's plain versions (quantize on load) against the
JAX package's ``_int8_conv(_quant_x(x, sx))`` and ``_int8_dot`` with the
reference's dequantization (``anuraxla/models/quant.py:243-246``, ``:256``),
bit for bit, on inputs with rounding ties and clamped codes; the dense's
split of K; the choices of tile, stage depth and form.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anuraxla.models import quant as jq
from anuraxla_torch.models import quant as tq
from anuraxla_torch.models.vae import VAEConfig, init_encoder_params
from anuraxla_torch.ops import int8 as ti8

SAME = ((0, 1), (0, 1))
PAD1 = ((1, 1), (1, 1))


def _weight(rng, cin, cout):
    return torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8))


@pytest.mark.parametrize("cout", [32, 256])
@pytest.mark.parametrize("cin", [1, 32, 64])
def test_pack_unpacks_to_hwio_with_zero_padding(cin, cout):
    """The packed W read back is the HWIO kernel as [9 Cin, Cout]; each
    byte sits where the kernel's descriptors read it (k32 step, 8-column
    group, 16-byte half, column, byte); K's padding is zeros."""
    w = _weight(np.random.default_rng(cin + cout), cin, cout)
    K = 9 * cin
    p = ti8.pack_weight(w)
    T, S, bn, bk = p.shape
    assert (T, bn, bk) == (1, cout, ti8.stage_depth(K)) and (S - 1) * bk < K <= S * bk
    w2 = w.reshape(K, cout)
    assert torch.equal(ti8.unpack_weight(p, K), w2)
    flat = p.reshape(T, S, bn * bk)
    wp = torch.zeros((S * bk, cout), dtype=torch.int8)
    wp[:K] = w2
    k = torch.arange(S * bk)[:, None]
    n = torch.arange(cout)[None, :]
    s, kk = k // bk, k % bk
    off = (kk // 32) * bn * 32 + (n // 8) * 256 + ((kk % 32) // 16) * 128 + (n % 8) * 16 + kk % 16
    assert torch.equal(flat[0, s.expand(-1, cout), off], wp)
    assert not flat.reshape(-1)[off[K:].reshape(-1) + (s[K:] * bn * bk).expand(-1, cout).reshape(-1)].any()


def test_pack_dense_column_tiles():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.integers(-127, 128, (1024, 512), dtype=np.int8))
    p = ti8.pack_weight(w)
    assert p.shape == (2, 8, 256, 128)
    assert torch.equal(ti8.unpack_weight(p, 1024), w)
    assert torch.equal(ti8.unpack_weight(p[1:], 1024), w[:, 256:])  # a column tile is the next 256 columns


def test_stage_depth_and_tiles():
    # K = 288 takes three stages of 96, not a pad to 384
    assert [ti8.stage_depth(k) for k in (9, 144, 288, 576, 1152, 2304, 12288)] == [32, 32, 96, 96, 128, 128, 128]
    assert ti8.wgmma_tile(9, 32) is None  # the first conv: the simple path
    assert ti8.wgmma_tile(288, 32) == (32, 96) and ti8.wgmma_tile(2304, 256) == (256, 128)
    assert ti8.wgmma_tile(288, 24) is None and ti8.wgmma_tile(288, 512) is None
    assert ti8.wgmma_tile(12288, 512, dense=True) == (256, 128) and ti8.wgmma_tile(100, 40, dense=True) is None


def test_halo_form_rules():
    """The halo form fits every wgmma conv of the default encoder, stride 1
    and 2, at B = 1024 and B = 1; a Cin that is no power of two, or stride 1
    with other pads than 1, takes the gathered form."""
    cfg = VAEConfig()
    (h, w), cin = cfg.input_hw, 1
    seen = []
    for width in cfg.widths:
        for stride in (2, 1):
            pads = tq._conv_pads(cfg, h, w, stride)
            tile = ti8.wgmma_tile(9 * cin, width)
            if tile:
                assert all(ti8.halo_fits(b, h, w, cin, width, stride, pads, tile[1]) for b in (1024, 1))
                seen.append(stride)
            (h, w), cin = ti8.conv_out_hw(h, w, stride, pads), width
    assert seen == [1, 2, 1, 2, 1, 2, 1]
    assert not ti8.halo_fits(1024, 96, 32, 48, 64, 1, PAD1, 96)  # Cin not a power of two
    assert not ti8.halo_fits(1024, 96, 32, 32, 64, 1, SAME, 96)  # stride 1 needs pads of 1


def test_halo_form_32_bit_limits():
    """The halo form indexes the input in 32 bits, as the launch checks: at
    96 x 32 x 32 the batch of 21845 fits (2^31 - 65536 input bytes), 21846
    takes the gathered form."""
    assert ti8.halo_fits(21845, 96, 32, 32, 32, 1, PAD1, 96)
    assert not ti8.halo_fits(21846, 96, 32, 32, 32, 1, PAD1, 96)
    assert ti8.halo_fits(21845, 96, 32, 32, 64, 2, SAME, 96)
    assert not ti8.halo_fits(21846, 96, 32, 32, 64, 2, SAME, 96)


@pytest.mark.parametrize("n_stages", [1, 3, 12, 96])
@pytest.mark.parametrize("m_tiles", [1, 8, 40])
def test_dense_splits_cover_k_once(m_tiles, n_stages):
    for n_sm in (1, 132):
        splits = ti8.dense_splits(m_tiles, 2, n_stages, n_sm)
        assert 1 <= splits <= n_stages and (splits == 1 or m_tiles * 2 * splits <= n_sm)
        ranges = ti8.split_ranges(n_stages, splits)
        covered = [s for b, e in ranges for s in range(b, e)]
        assert covered == list(range(n_stages)) and all(e > b for b, e in ranges)
    assert ti8.dense_splits(8, 2, 96) == 8 and ti8.dense_splits(1, 2, 96) == 66


def _x_ties_and_clamps(rng, shape, sx):
    """f32 x: a third of it exact rounding ties (k + 1/2) sx (sx a power of
    two), a third past +-127 sx (clamped codes), the rest random."""
    sxb = sx.reshape(-1, *[1] * (len(shape) - 1))
    u = rng.standard_normal(shape).astype(np.float32) * 40
    pick = rng.integers(0, 3, shape)
    u = np.where(pick == 0, rng.integers(-140, 140, shape) + 0.5, u)
    u = np.where(pick == 1, np.sign(u + 1e-3) * rng.uniform(127.6, 400, shape), u)
    return (u * sxb).astype(np.float32)


def _scales(rng, B):
    return (2.0 ** rng.integers(-8, -2, B)).astype(np.float32)


@pytest.mark.parametrize("shape", [
    (3, 12, 8, 16, 32, 1, PAD1),
    (2, 13, 9, 32, 16, 2, SAME),
    (2, 12, 8, 32, 16, 2, PAD1),   # TORCH pads
    (1, 9, 7, 1, 8, 2, SAME),      # B = 1, the first conv's K = 9
], ids=["s1", "s2_same", "s2_torch", "b1_k9"])
def test_f32_mode_plain_conv_bitwise_jax(shape):
    B, H, W, cin, cout, stride, pads = shape
    rng = np.random.default_rng(sum(shape[:5]))
    sx = _scales(rng, B)
    x = _x_ties_and_clamps(rng, (B, H, W, cin), sx)
    u = x / sx.reshape(-1, 1, 1, 1)
    assert (u - np.floor(u) == 0.5).sum() > 0 and (np.abs(u) > 127.5).sum() > 0
    w = _weight(rng, cin, cout)
    sw = rng.uniform(1e-4, 1e-2, cout).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)

    sxj = jnp.asarray(sx.reshape(-1, 1, 1, 1))
    xq = jq._quant_x(jnp.asarray(x), sxj)
    yj = jq._int8_conv(xq, jnp.asarray(w.numpy()), stride, pads)
    fj = yj.astype(jnp.float32) * (sxj * jnp.asarray(sw)) + jnp.asarray(bias)  # quant.py:244

    t = [torch.from_numpy(a) for a in (x, sx, sw, bias)]
    codes = ti8.quantize_rows(t[0], t[1])
    assert np.array_equal(codes.numpy(), np.asarray(xq))
    raw = ti8.int8_conv_plain(t[0], w, t[1], t[2], t[3], stride, pads, raw=True)
    out = ti8.int8_conv_plain(t[0], w, t[1], t[2], t[3], stride, pads)
    assert raw.dtype == torch.int32 and np.array_equal(raw.numpy(), np.asarray(yj))
    assert np.array_equal(out.numpy(), np.asarray(fj))
    # the wrapper on a CPU tensor is the plain version, in both operand modes
    n0 = ti8.launches()
    assert torch.equal(ti8.int8_conv(t[0], w, t[1], t[2], t[3], stride, pads), out)
    assert torch.equal(ti8.int8_conv(codes, w, t[1], t[2], t[3], stride, pads), out)
    assert ti8.launches() == n0


@pytest.mark.parametrize("m", [1, 5])
def test_f32_mode_plain_dense_bitwise_jax(m):
    K, N = 96, 24
    rng = np.random.default_rng(m)
    sx = _scales(rng, m)
    x = _x_ties_and_clamps(rng, (m, K), sx)
    w = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    sw = rng.uniform(1e-4, 1e-2, N).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)

    sxj = jnp.asarray(sx.reshape(-1, 1))
    yj = jq._int8_dot(jq._quant_x(jnp.asarray(x), sxj), jnp.asarray(w.numpy()))
    fj = yj.astype(jnp.float32) * (sxj * jnp.asarray(sw)) + jnp.asarray(bias)  # quant.py:256

    t = [torch.from_numpy(a) for a in (x, sx.reshape(-1, 1), sw, bias)]
    raw = ti8.int8_dense(t[0], w, t[1], t[2], t[3], raw=True)
    assert raw.dtype == torch.int32 and np.array_equal(raw.numpy(), np.asarray(yj))
    assert np.array_equal(ti8.int8_dense(t[0], w, t[1], t[2], t[3]).numpy(), np.asarray(fj))
    one = torch.tensor(2.0 ** -4)  # a calibrated scale: one value for every row
    yj1 = jq._int8_dot(jq._quant_x(jnp.asarray(x), jnp.float32(2.0 ** -4)), jnp.asarray(w.numpy()))
    assert np.array_equal(ti8.int8_dense_plain(t[0], w, one, t[2], t[3], raw=True).numpy(), np.asarray(yj1))


def test_operand_checks_and_cpu_tree(monkeypatch):
    """x is int8 codes or f32, nothing else; on the CPU the quantized tree
    holds no packed W (its keys stay the reference's) and the forward
    quantizes first (``_quant_x``, int8 codes to the wrappers); f32 x handed
    to the wrappers, as the card's forward hands it, gives the same bits."""
    w = torch.zeros((3, 3, 4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 codes or float32"):
        ti8.int8_conv(torch.zeros((1, 5, 5, 4), dtype=torch.float64), w, torch.ones(1), torch.ones(8),
                      torch.zeros(8), 1, PAD1)
    cfg = VAEConfig(widths=(32, 64), dense_width=32, latent_dim=8, input_hw=(16, 16), groups=4)
    q = tq.quantize_encoder(init_encoder_params(cfg, torch.Generator().manual_seed(0)), cfg, device="cpu")
    assert all(set(c) == {"wq", "sw", "bias"} for c in q["conv"].values())
    x = torch.randn(2, 16, 16, 1)
    seen = []

    def conv(v, *a, **k):
        seen.append(v.dtype)
        return ti8.int8_conv(v, *a, **k)

    monkeypatch.setattr(tq, "int8_conv", conv)
    a = tq.encoder_apply_quantized(q, cfg, x)["mu"]
    assert seen == [torch.int8] * 4
    monkeypatch.setattr(tq, "_quant_x", lambda v, sx: v)
    assert torch.equal(a, tq.encoder_apply_quantized(q, cfg, x)["mu"]) and seen[4:] == [torch.float32] * 4
