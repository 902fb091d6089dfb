"""Shared CLI plumbing — the port of ``anuraxla/cli/common.py``: the mel,
device and encoder flags, ``--serving-tier`` and the three knobs a tier
bundles, ``--quantize-serving`` (int8 encoder contractions,
``models.quant``), ``--data-parallel`` (batches split over the data shards of
``parallel.mesh``: the visible cards), and the project-root resolution of
``--config`` and ``--root`` (relative paths resolve against the project root,
not the working directory, as in the reference).

The tier table names the port's backends (the reference's ``pallas`` is
``cuda`` here, ``pallas-bf16`` is ``cuda-bf16``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from anuraxla_torch.constants import MelConfig
from anuraxla_torch.ops.frontend import BACKENDS
from anuraxla_torch.utils.io import find_project_root, resolve_root_dir

__all__ = [
    "add_mel_args", "add_device_arg", "add_encoder_args", "add_batch_args", "mel_from_args", "session_kwargs",
    "resolve_config", "project_root_here", "resolve_root_dir",
]


def add_mel_args(p: argparse.ArgumentParser, duration_default: float | None = None) -> None:
    p.add_argument("--sr", type=int, default=48000)
    p.add_argument("--n-mels", type=int, default=64)
    p.add_argument("--target-frames", type=int, default=192)
    p.add_argument("--fmin", type=float, default=150.0)
    p.add_argument("--fmax", type=float, default=15000.0)
    p.add_argument("--hop-length", type=int, default=384)
    p.add_argument("--n-fft", type=int, default=2048)
    if duration_default is not None:
        p.add_argument("--duration", type=float, default=duration_default)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default: the card) or 'cpu' (the kernels' plain versions)")


def add_encoder_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--encoder", type=str, default=None,
        help="encoder artifact dir (encoder.msgpack + encoder.json, written by "
        "either package); defaults to <project_root>/models/anuraxla_vae_encoder_v0, "
        "falling back to a seeded init (with a warning) if absent",
    )
    # the reference's hidden flag, accepted so that its command lines parse;
    # the seeded-init fallback is always allowed
    p.add_argument("--allow-init-encoder", action="store_true", default=True, help=argparse.SUPPRESS)


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
        "--data-parallel", action="store_true",
        help="split encode batches over every visible card (one encoder replica "
        "each); fits then run sample-sharded over them (parallel.fit)",
    )
    p.add_argument(
        "--transfer-int16", action="store_true",
        help="ship audio to the device as PCM16 (half the host->device bytes; "
        "lossless for 16-bit source files)",
    )
    p.add_argument(
        "--quantize-serving", action="store_true",
        help="int8 encoder contractions (models.quant: int8 weights per output "
        "channel, int8 activations per row, int32 sums on the card's integer "
        "tensor cores); post-training-quantization latent tolerance, latent "
        "caches fingerprinted separately (_q8). Not with a bfloat16 encoder",
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
        "data_parallel": getattr(args, "data_parallel", False),
        "quantize": getattr(args, "quantize_serving", False),
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


def resolve_config(config_arg: str, project_root: Path) -> Path:
    cfg_path = Path(config_arg)
    if not cfg_path.is_absolute():
        cfg_path = (project_root / cfg_path).resolve()
    if not cfg_path.exists():
        raise SystemExit(f"❌ config.json not found at: {cfg_path}")
    return cfg_path


def project_root_here() -> Path:
    return find_project_root(Path.cwd())
