"""Least work and least bytes of the served model, counted from its shapes.

``encoder_macs``: the stride family's count is a frozen copy of the encoder
part of ``anuraxla_torch/bench.py`` ``pipeline_flops`` (a stride-2 and a
stride-1 3x3 convolution a block, the dense layer, the two heads); the
avgpool family runs one stride-1 convolution a block at the block's input
size, then halves. The mel's least work is a real FFT a frame (2.5 N log2 N)
plus the filterbank (2 n_freq n_mels) over every frame the clip needs (the
dB reference and the statistics span the whole clip), never the dense-DFT
count. FLOP = 2 MAC.
"""

from __future__ import annotations

import math

from perfbench import families


def total_frames(mel: dict) -> int:
    return 1 + int(mel["sr"] * mel["duration"]) // mel["hop_length"]


def encoder_macs(cfg: dict) -> int:
    t, m = cfg["input_hw"]
    cin, macs = 1, 0
    for w in cfg["widths"]:
        if cfg["downsample"] == "avgpool":
            macs += t * m * 9 * cin * w
            t, m = t // 2, m // 2
        else:
            t, m = -(-t // 2), -(-m // 2)
            macs += t * m * 9 * cin * w + t * m * 9 * w * w
        cin = w
    macs += t * m * cin * cfg["dense_width"]
    macs += 2 * cfg["dense_width"] * cfg["latent_dim"]
    return macs


def decoder_macs(cfg: dict) -> int:
    """The native decoder: two dense layers, a 4x4 stride-2 transposed
    convolution and a 3x3 convolution a block, a last transposed convolution
    to 16 channels and the 3x3 output convolution."""
    t, m = cfg["input_hw"]
    for _ in cfg["widths"]:
        t, m = -(-t // 2), -(-m // 2)
    w0 = cfg["widths"][-1]
    macs = cfg["latent_dim"] * cfg["dense_width"] + cfg["dense_width"] * t * m * w0
    chans = [w0] + list(reversed(cfg["widths"][:-1])) + [16]
    for i in range(len(chans) - 1):
        t, m = 2 * t, 2 * m
        macs += t * m * 4 * chans[i] * chans[i + 1]  # an output pixel of a stride-2 4x4 sees 2x2 of its taps
        if i < len(chans) - 2:
            macs += t * m * 9 * chans[i + 1] * chans[i + 1]
    macs += t * m * 9 * 16
    return macs


def mel_flops_per_row(mel: dict) -> float:
    n, n_freq = mel["n_fft"], mel["n_fft"] // 2 + 1
    return total_frames(mel) * (2.5 * n * math.log2(n) + 2.0 * n_freq * mel["n_mels"])


def mel_bytes_per_row(mel: dict) -> float:
    """The row's samples read once as float32, the mel power written once as float32."""
    return 4.0 * int(mel["sr"] * mel["duration"]) + 4.0 * total_frames(mel) * mel["n_mels"]


def chunk_flops(cfg: dict) -> float:
    """One 5 s chunk served: the mel's least work and the encoder's, as the
    configuration's family counts it."""
    return mel_flops_per_row(cfg["mel"]) + 2.0 * families.of(cfg).encoder_macs(cfg)


def train_example_flops(cfg: dict) -> float:
    """One training example: its mel, and the VAE's forward and backward
    counted as three forwards."""
    return mel_flops_per_row(cfg["mel"]) + 3 * 2.0 * (encoder_macs(cfg) + decoder_macs(cfg))
