"""The conv-VAE encoder (``anuraxla_torch/models/vae.py`` ``ConvVAEEncoder``):
stride-2 / stride-1 3x3 pairs or a conv and a 2x2 average pool a block,
GroupNorm, the dense layer and the ``mu`` / ``logvar`` heads. Its reference is
``perfbench/reference/encoder.py``, its least work
``perfbench/yardstick/flops.py`` ``encoder_macs``."""

from __future__ import annotations

from perfbench.reference import encoder as ref_encoder
from perfbench.yardstick import flops


def program_config(cfg: dict):
    from anuraxla_torch.models.vae import VAEConfig

    c = cfg
    return VAEConfig(latent_dim=c["latent_dim"], widths=tuple(c["widths"]), dense_width=c["dense_width"],
                     groups=c["groups"], input_hw=tuple(c["input_hw"]), conv_padding=c["conv_padding"],
                     gn_eps=c["gn_eps"], activation=c["activation"], downsample=c["downsample"])


def make_params(cfg: dict, seed: int, device):
    return ref_encoder.make_params(cfg, seed, device)


def encode(params, mels, cfg: dict, rounding=None):
    return ref_encoder.encode(params, mels, cfg, rounding=rounding)["mu"]


def latent_dim(cfg: dict) -> int:
    return cfg["latent_dim"]


def encoder_macs(cfg: dict) -> int:
    return flops.encoder_macs(cfg)


def cpu_cut(cfg: dict) -> dict:
    """Unchanged: the published widths run on the CPU in a fraction of a second a batch."""
    return cfg
