"""Shared CLI plumbing — the port of ``anuraxla/cli/common.py``'s serving
flags: the mel flags, ``--serving-tier`` and the three knobs a tier bundles.

The tier table names the port's backends (the reference's ``pallas`` is
``cuda`` here, ``pallas-bf16`` is ``cuda-bf16``). ``--data-parallel`` and
``--quantize-serving`` belong to later slices of the port (torch.distributed
serving, int8) and are not flags here yet.
"""

from __future__ import annotations

import argparse

from anuraxla_torch.constants import MelConfig
from anuraxla_torch.ops.frontend import BACKENDS


def add_mel_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--sr", type=int, default=48000)
    p.add_argument("--n-mels", type=int, default=64)
    p.add_argument("--target-frames", type=int, default=192)
    p.add_argument("--fmin", type=float, default=150.0)
    p.add_argument("--fmax", type=float, default=15000.0)
    p.add_argument("--hop-length", type=int, default=384)
    p.add_argument("--n-fft", type=int, default=2048)


def add_batch_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch-size", type=int, default=64, help="device batch size")
    p.add_argument("--io-threads", type=int, default=16, help="host decode threads")
    p.add_argument(
        "--serving-tier", type=str, default="custom",
        choices=["custom", "parity", "balanced", "fast"],
        help="named operating point bundling the frontend/encoder knobs (an "
        "individual flag below overrides a tier's choice when typed). "
        "'parity' = exact-f32 mel kernel + f32 encoder; "
        "'balanced' = exact-f32 mel kernel + bf16-trunk encoder; "
        "'fast' = crop-first frontend + bf16 mel kernel + bf16-trunk encoder "
        "(not bit-identical to 'parity'; decisions are held equal on the "
        "test trees); 'custom' (default) = exactly the individual flags",
    )
    # the three tier-controlled knobs default to None so resolve_tier_knobs
    # can tell "user typed the flag" from "flag absent": an explicit value
    # beats the tier even when it equals the built-in default
    p.add_argument(
        "--fast-frontend", action="store_true", default=None,
        help="crop-first mel frontend: compute only the frames that survive "
        "the center crop; statistically equivalent for detection, not "
        "bit-identical to librosa",
    )
    p.add_argument(
        "--frontend-backend", type=str, default=None, choices=list(BACKENDS),
        help="STFT/mel implementation (cuda = fused mel kernel, exact f32; "
        "cuda-bf16 = its bf16 mode; matmul / matmul-bf16 = dense bases). "
        "Default: cuda (or the --serving-tier's choice)",
    )
    p.add_argument(
        "--transfer-int16", action="store_true",
        help="ship audio to the device as PCM16 (half the host->device bytes; "
        "lossless for 16-bit source files)",
    )
    p.add_argument(
        "--pre-padded-host", action="store_true",
        help="decode WAVs directly into the ct kernel's pre-padded row layout. "
        "Requires parity mode, --frontend-backend cuda, hop %% 128 == 0",
    )
    p.add_argument(
        "--encoder-dtype", type=str, default=None, choices=["float32", "bfloat16"],
        help="encoder trunk compute dtype (params stay f32; the mu/logvar "
        "heads always run f32). Default: float32 (or the --serving-tier's choice)",
    )


# knob bundles behind --serving-tier; an individual flag the user typed
# always wins over the tier's choice
SERVING_TIERS = {
    "parity": {"fast_frontend": False, "frontend_backend": "cuda",
               "encoder_dtype": "float32"},
    "balanced": {"fast_frontend": False, "frontend_backend": "cuda",
                 "encoder_dtype": "bfloat16"},
    "fast": {"fast_frontend": True, "frontend_backend": "cuda-bf16",
             "encoder_dtype": "bfloat16"},
}
# the port's session defaults to its kernel backend (the reference's CLI
# default is matmul; its served tiers all name the kernel)
_TIER_FLAG_DEFAULTS = {
    "fast_frontend": False, "frontend_backend": "cuda",
    "encoder_dtype": "float32",
}


def resolve_tier_knobs(args) -> dict:
    """(fast_frontend, frontend_backend, encoder_dtype) after applying
    --serving-tier. The knob flags carry None-sentinel argparse defaults, so
    presence is unambiguous: a flag the user typed overrides the tier even
    when its value equals the built-in default (a tier is a bundle of
    defaults, not a lock); absent flags take the tier's value, then the
    built-in default."""
    tier_vals = SERVING_TIERS.get(getattr(args, "serving_tier", "custom"), {})
    knobs = {}
    for k, builtin in _TIER_FLAG_DEFAULTS.items():
        v = getattr(args, k, None)
        knobs[k] = v if v is not None else tier_vals.get(k, builtin)
    return knobs


def session_kwargs(args) -> dict:
    knobs = resolve_tier_knobs(args)
    return {
        "batch_size": args.batch_size,
        "num_threads": args.io_threads,
        "parity": not knobs["fast_frontend"],
        "backend": knobs["frontend_backend"],
        "transfer_int16": getattr(args, "transfer_int16", False),
        "encoder_dtype": knobs["encoder_dtype"],
        "pre_padded_host": getattr(args, "pre_padded_host", False),
    }


def mel_from_args(args, duration: float) -> MelConfig:
    return MelConfig(
        sr=args.sr,
        duration=duration,
        n_mels=args.n_mels,
        fmin=args.fmin,
        fmax=args.fmax,
        hop_length=args.hop_length,
        n_fft=args.n_fft,
        target_frames=args.target_frames,
    )
