"""Scoped full-f32 arithmetic on the card.

A float32 convolution goes through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits and breaks the f32 parity tier. ``exact_f32()`` turns TF32 off
for cuDNN and for matmuls inside its block and restores both flags after, so
the port leaves no global side effect.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled,
            benchmark=torch.backends.cudnn.benchmark,
            deterministic=torch.backends.cudnn.deterministic,
            allow_tf32=False,
        ):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
