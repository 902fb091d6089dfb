"""anuraxla_torch — the PyTorch/CUDA port of ``anuraxla`` for NVIDIA Hopper.

Each module carries the name of its counterpart in ``anuraxla`` so a reader
can find the reference it is held against. The package imports torch, numpy
and scipy, and nothing of JAX, flax, msgpack or ``anuraxla``: what it needs from the
reference's jax-free modules is copied here.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; asking for CUDA on a host without a card raises.
"""

from anuraxla_torch.constants import DEFAULT_MEL, MelConfig

__all__ = ["DEFAULT_MEL", "MelConfig", "resolve_device"]


def resolve_device(device="cuda"):
    """``torch.device`` for ``device``; raises when CUDA is asked for and no
    card is visible, and for anything but a CUDA or CPU device (the
    reference's ``auto`` included) — the port never continues quietly on the
    CPU."""
    import torch

    try:
        dev = torch.device(device)
    except RuntimeError:
        dev = None
    if dev is None or dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r}: the port runs on 'cuda' (the card) or 'cpu' (the kernels' plain "
                         "versions); there is no automatic choice")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev
