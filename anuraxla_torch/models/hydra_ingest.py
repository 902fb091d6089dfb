"""Ingest the reference's external encoder and decoder artifacts — the port
of ``anuraxla/models/hydra_ingest.py``: a torch checkpoint (pickled module,
wrapped or raw state_dict) plus a Hydra-style YAML sidecar whose
``encoder._target_`` tree describes the architecture
(``ref:map_detector_core.py:107-179``).

The reference needs the private ``soundscape_vae`` package at load time —
``instantiate(enc_cfg)`` returns a factory that is called once to get the
nn.Module (``ref:map_detector_core.py:135-147``). This module removes that
dependency for the documented layer vocabulary (3x3-Conv2d / GroupNorm /
BatchNorm2d-folded / norm-free / Linear feed-forward stacks, with either
stride-2-pair or conv+AvgPool2d(2) downsampling — the shape contract of
``ref:07:7-13``); anything else raises a named
:class:`UnsupportedLayerError` (its messages are the JAX package's, word for
word), and for runnable pickled modules the error carries the module's
probed target_frames:

- ``load_yaml_cfg`` / ``pick_encoder_cfg``: same YAML handling, interpolations
  deliberately NOT resolved (reference behavior).
- ``instantiate_target_tree``: a mini-instantiate for ``_target_`` trees.
  Importable targets import; unimportable private paths fall back to the
  terminal class name resolved against ``torch.nn`` — so a YAML that says
  ``soundscape_vae.layers.Conv2d`` still builds. The factory-call convention
  is honored (callable-but-not-module results are called once).
- shape-based state_dict mapping: foreign tensor NAMES never matter — tensors
  are classified by shape/role in registration order (torch state_dicts
  preserve forward order for sequential nets) and mapped onto the slots of
  the JAX package's ``ConvVAEEncoder`` tree with layout conversion
  (``map_foreign_state_dict``, numpy, the same tree both packages build);
  ``ingest_foreign_checkpoint`` carries it into the port's ``state_dict``
  (``models.convert.encoder_state_from_jax``), ``ingest_foreign_decoder``
  likewise over ``ingested_decoder_slots``.
- ``auto_find_frames``: the closed form of the reference's forward-hook probe
  (``ref:07:355-409``): the downsampling chain is known, so candidate
  ``target_frames`` are checked against the ingested dense layer's
  ``in_features`` one multiply each.
- ``probe_frames_with_hook``: the reference's probe ITSELF, for opaque
  runnable modules — used to cross-check the closed form whenever the
  checkpoint is a pickled nn.Module, and to make out-of-vocabulary
  failures actionable.

Ingested configs set ``conv_padding="TORCH"`` and ``gn_eps=1e-5`` so the
port's encoder reproduces torch Conv2d(padding=1) / GroupNorm(eps=1e-5).
"""

from __future__ import annotations

import importlib
import math
import warnings
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from anuraxla_torch.models.convert import encoder_state_from_jax, ingested_decoder_slots, state_from_jax
from anuraxla_torch.models.ingest import (
    convert_conv,
    convert_groupnorm,
    convert_linear,
    split_model_and_state,
)
from anuraxla_torch.models.vae import DecoderSpec, VAEConfig, bottleneck_for as _vae_bottleneck_for


# ---------------------------------------------------------------------------
# YAML handling (reference: load_yaml_cfg / pick_encoder_cfg)
# ---------------------------------------------------------------------------

def load_yaml_cfg(path: str | Path) -> Dict[str, Any]:
    """Parse the Hydra YAML *without* resolving interpolations — the reference
    passes resolve=False for the same reason (``ref:map_detector_core.py:111``):
    the values reference a training environment that no longer exists."""
    import yaml

    cfg = yaml.safe_load(Path(path).read_text())
    if not isinstance(cfg, dict):
        raise ValueError(f"YAML did not parse to a mapping: {path}")
    return cfg


def pick_encoder_cfg(cfg: Mapping[str, Any]) -> Dict[str, Any]:
    enc = cfg.get("encoder")
    if isinstance(enc, Mapping) and "_target_" in enc:
        return dict(enc)
    raise ValueError("YAML has no 'encoder:' block with a _target_")


# ---------------------------------------------------------------------------
# Mini-instantiate for _target_ trees (torch.nn vocabulary)
# ---------------------------------------------------------------------------

def _resolve_target(target: str):
    """Import a dotted target; if the module path is unimportable (private
    package), resolve the terminal class name against torch.nn."""
    mod_path, _, name = target.rpartition(".")
    if mod_path:
        try:
            return getattr(importlib.import_module(mod_path), name)
        except (ImportError, AttributeError):
            pass
    import torch.nn as torch_nn

    if hasattr(torch_nn, name):
        return getattr(torch_nn, name)
    raise ImportError(
        f"cannot resolve _target_ '{target}': module not importable and "
        f"'{name}' is not a torch.nn layer"
    )


def instantiate_target_tree(node: Any) -> Any:
    """Recursively instantiate a Hydra-style config node. Dicts with
    ``_target_`` become objects (kwargs instantiated first, ``_args_``
    positional); plain dicts/lists recurse; leaves pass through."""
    if isinstance(node, Mapping):
        if "_target_" in node:
            cls = _resolve_target(str(node["_target_"]))
            args = [instantiate_target_tree(a) for a in node.get("_args_", [])]
            kwargs = {
                k: instantiate_target_tree(v)
                for k, v in node.items()
                # drop ALL Hydra meta-keys (real config dumps carry
                # _recursive_/_convert_ inside _target_ nodes)
                if k not in ("_target_", "_args_", "_partial_", "_recursive_", "_convert_")
            }
            if node.get("_partial_"):
                import functools

                return functools.partial(cls, *args, **kwargs)
            return cls(*args, **kwargs)
        return {k: instantiate_target_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        vals = [instantiate_target_tree(v) for v in node]
        return type(node)(vals) if isinstance(node, tuple) else vals
    return node


def build_nn_module(obj: Any):
    """Reference factory convention (``ref:map_detector_core.py:135-147``):
    instantiate() may return the module or a zero-arg factory for it."""
    import torch.nn as torch_nn

    if isinstance(obj, torch_nn.Module):
        return obj
    if callable(obj):
        m = obj()
        if isinstance(m, torch_nn.Module):
            return m
        raise TypeError(f"factory() returned {type(m)}, not nn.Module")
    raise TypeError(f"cannot build nn.Module from {type(obj)}")


# ---------------------------------------------------------------------------
# Shape-based state_dict analysis
# ---------------------------------------------------------------------------

class UnsupportedLayerError(ValueError):
    """A state_dict tensor (named!) falls outside the ingestable layer
    vocabulary — raised instead of letting the shape mapper miss downstream
    with an unhelpful shape mismatch (VERDICT r2 item 6)."""


def _shape_of(v) -> Tuple[int, ...]:
    return tuple(getattr(v, "shape", np.asarray(v).shape))


def parse_layer_stream(sd: Mapping[str, Any]) -> List[Dict[str, Any]]:
    """Classify the tensor stream into typed layers by shape + registration
    order (names are only a tiebreak for one genuinely shape-ambiguous case).

    Supported vocabulary:
      - 3x3 Conv2d, with or without bias;
      - GroupNorm (weight+bias pair after a conv);
      - BatchNorm2d (weight+bias+running_mean+running_var after a conv, or
        affine=False: running_mean+running_var only, identified by the
        'running_*' names torch always gives those buffers);
      - no norm at all after a conv;
      - Linear (weight+bias), for the dense bottleneck and the heads.

    Anything else raises :class:`UnsupportedLayerError` naming the tensor:
    non-3x3 kernels, Conv1d/Conv3d ranks, bias-less linears, unexpected
    1-D runs (PReLU/LayerNorm/...), trailing norms with no conv.
    """
    stream = [
        (k, v, _shape_of(v))
        for k, v in sd.items()
        if "num_batches_tracked" not in k
    ]
    layers: List[Dict[str, Any]] = []
    i = 0
    while i < len(stream):
        k, v, s = stream[i]
        if len(s) == 4:
            o, c, kh, kw = s
            if (kh, kw) != (3, 3):
                raise UnsupportedLayerError(
                    f"conv '{k}' has kernel {kh}x{kw}; only 3x3 convs are "
                    "ingestable (ConvVAEEncoder vocabulary)"
                )
            i += 1
            # the following run of length-o 1-D tensors = [bias][norm params]
            run: List[Tuple[str, Any]] = []
            while i < len(stream) and len(stream[i][2]) == 1:
                if stream[i][2][0] != o:
                    raise UnsupportedLayerError(
                        f"1-D tensor '{stream[i][0]}' of length {stream[i][2][0]} "
                        f"after conv '{k}' (out={o}) — not a bias/norm parameter "
                        "of that conv; unsupported layer family"
                    )
                run.append((stream[i][0], stream[i][1]))
                i += 1
            if len(run) > 5:
                names = [n for n, _ in run]
                raise UnsupportedLayerError(
                    f"{len(run)} consecutive per-channel tensors after conv "
                    f"'{k}': {names} — more than one norm layer per conv is "
                    "not ingestable"
                )
            has_bias = len(run) in (1, 3, 5)
            bias = run[0][1] if has_bias else None
            norm_run = run[1:] if has_bias else run
            if len(norm_run) == 0:
                norm = None
            elif len(norm_run) == 2:
                # weight+bias -> GroupNorm, UNLESS the names say these are
                # BatchNorm running stats (affine=False BN registers only
                # running_mean/running_var — shape-identical to a GN pair)
                if any("running" in n for n, _ in norm_run):
                    norm = {"kind": "bn", "gamma": None, "beta": None,
                            "mean": norm_run[0][1], "var": norm_run[1][1]}
                else:
                    norm = {"kind": "gn", "scale": norm_run[0][1], "bias": norm_run[1][1]}
            elif len(norm_run) == 4:
                norm = {"kind": "bn", "gamma": norm_run[0][1], "beta": norm_run[1][1],
                        "mean": norm_run[2][1], "var": norm_run[3][1]}
            else:
                names = [n for n, _ in norm_run]
                raise UnsupportedLayerError(
                    f"cannot classify the {len(norm_run)} per-channel tensors "
                    f"after conv '{k}': {names} (expected GroupNorm pair or "
                    "BatchNorm quadruple)"
                )
            layers.append({"kind": "conv", "name": k, "w": v, "b": bias,
                           "out": int(o), "cin": int(c), "norm": norm})
        elif len(s) == 2:
            o = s[0]
            if (
                i + 1 >= len(stream)
                or len(stream[i + 1][2]) != 1
                or stream[i + 1][2][0] != o
            ):
                raise UnsupportedLayerError(
                    f"linear '{k}' {s} has no bias tensor following it — "
                    "bias-less linears are outside the ingest vocabulary"
                )
            layers.append({"kind": "linear", "name": k, "w": v,
                           "b": stream[i + 1][1], "out": int(o), "cin": int(s[1])})
            i += 2
        elif len(s) == 1:
            raise UnsupportedLayerError(
                f"per-channel tensor '{k}' (length {s[0]}) with no preceding "
                "conv to attach to — truncated, reordered, or non-conv "
                "state_dict"
            )
        else:
            raise UnsupportedLayerError(
                f"tensor '{k}' has rank {len(s)} (shape {s}) — not a Conv2d/"
                "GroupNorm/BatchNorm2d/Linear parameter (Conv1d/Conv3d/"
                "attention stacks are not ingestable)"
            )
    return layers


def _split_convs_and_linears(layers: List[Dict[str, Any]]):
    convs = [l for l in layers if l["kind"] == "conv"]
    linears = [l for l in layers if l["kind"] == "linear"]
    # the stream must be all convs, then all linears (feed-forward stacks)
    kinds = [l["kind"] for l in layers]
    if kinds != ["conv"] * len(convs) + ["linear"] * len(linears):
        first_bad = next(
            l["name"] for j, l in enumerate(layers)
            if l["kind"] == "conv" and j > kinds.index("linear")
        )
        raise UnsupportedLayerError(
            f"conv '{first_bad}' appears after a linear layer — only "
            "conv-stack-then-dense feed-forward encoders are ingestable"
        )
    return convs, linears


def _conv_chain_hypotheses(
    convs: List[Dict[str, Any]], cin0: int = 1
) -> List[Tuple[str, List[int]]]:
    """Structurally valid (downsample, widths) readings of the conv channel
    chain. "stride": per block a (cin->w) stride-2 conv then a (w->w)
    stride-1 conv; "avgpool": one (cin->w) conv per block. A chain can fit
    both (repeated widths) — the caller disambiguates via the bottleneck
    arithmetic; stride (the native family) is listed first."""
    hyps: List[Tuple[str, List[int]]] = []
    if len(convs) % 2 == 0 and convs:
        widths, cin, ok = [], cin0, True
        for i in range(0, len(convs), 2):
            c1, c2 = convs[i], convs[i + 1]
            if c1["cin"] != cin or c2["cin"] != c1["out"] or c2["out"] != c1["out"]:
                ok = False
                break
            widths.append(c1["out"])
            cin = c1["out"]
        if ok:
            hyps.append(("stride", widths))
    widths, cin, ok = [], cin0, True
    for c in convs:
        if c["cin"] != cin:
            ok = False
            break
        widths.append(c["out"])
        cin = c["out"]
    if ok:
        hyps.append(("avgpool", widths))
    return hyps


def _norm_mode(convs: List[Dict[str, Any]]) -> str:
    """'group' | 'none' from the per-conv norm kinds; mixed kinds error."""
    kinds = {(c["norm"] or {"kind": "none"})["kind"] if c["norm"] else "none"
             for c in convs}
    if kinds == {"gn"}:
        return "group"
    if kinds <= {"bn", "none"}:
        return "none"  # BN folds into the convs; bare convs need no norm
    raise UnsupportedLayerError(
        f"mixed normalization kinds across the conv stack: {sorted(kinds)} — "
        "blocks must be uniformly GroupNorm, uniformly BatchNorm, or norm-free"
    )


def infer_vae_config_from_state_dict(
    sd: Mapping[str, Any],
    *,
    n_mels: int = 64,
    groups: Optional[int] = None,
    yaml_cfg: Optional[Mapping[str, Any]] = None,
    downsample: Optional[str] = None,
    probed_frames: Optional[int] = None,
) -> VAEConfig:
    """Derive the ConvVAEEncoder-compatible architecture from tensor shapes
    alone: conv pairs give widths, the first 2-D tensor gives dense_width,
    the head rows give latent_dim, and ``auto_find_frames`` recovers
    target_frames from the dense in_features. GroupNorm checkpoints keep
    ``norm='group'`` (``groups`` falls back to a recursive YAML search for
    num_groups/groups, then 8); BatchNorm or norm-free checkpoints get
    ``norm='none'`` (the BN affine folds into the convs at mapping time)."""
    layers = parse_layer_stream(sd)
    convs, linears = _split_convs_and_linears(layers)
    if not convs or len(linears) < 2:
        raise UnsupportedLayerError(
            f"state_dict outside the supported vocabulary: {len(convs)} conv "
            f"and {len(linears)} linear layers (need conv blocks + dense + heads)"
        )
    hyps = _conv_chain_hypotheses(convs)
    if not hyps:
        pairs = [f"({c['out']},{c['cin']})" for c in convs]
        raise UnsupportedLayerError(
            f"conv channel chain {' '.join(pairs)} fits neither the stride "
            "family (stride-2/stride-1 pairs per block) nor the avgpool "
            "family (one conv per block)"
        )
    norm = _norm_mode(convs)

    dense = linears[0]
    heads = linears[1:]
    if len(heads) not in (1, 2):
        raise UnsupportedLayerError(
            f"expected 1 (mu) or 2 (mu+logvar) head linears, got {len(heads)} "
            f"(first extra: '{heads[2]['name']}')" if len(heads) > 2 else
            f"expected 1 (mu) or 2 (mu+logvar) head linears, got {len(heads)}"
        )
    latent_dim = heads[0]["out"]
    for h in heads:
        if (h["out"], h["cin"]) != (latent_dim, dense["out"]):
            raise UnsupportedLayerError(
                f"head '{h['name']}' has shape ({h['out']},{h['cin']}), "
                f"expected ({latent_dim},{dense['out']})"
            )

    if groups is None:
        groups = _find_int_key(yaml_cfg or {}, ("num_groups", "groups")) or 8

    # Evaluate EVERY structurally valid hypothesis against the dense
    # layer's in_features. A repeated-width avgpool net can masquerade as
    # stride pairs by shape AND by arithmetic (e.g. chain 1→8,8→8,8→16,
    # 16→16 with in_features=1024: avgpool t=512 and stride t=29 both
    # explain it), so ambiguity is resolved, in order, by: the explicit
    # ``downsample`` override (--downsample on the CLI), the runnable
    # module's forward-hook probe (``probed_frames`` — the closed form
    # under the TRUE hypothesis finds the same smallest t the probe
    # measures), else prefer stride (the native family) with a LOUD
    # warning naming the alternative reading.
    if downsample is not None:
        hyps = [(ds, w) for ds, w in hyps if ds == downsample]
        if not hyps:
            raise UnsupportedLayerError(
                f"the conv chain does not fit downsample={downsample!r}"
            )
    matches, errs = [], []
    for ds, widths in hyps:
        try:
            t = auto_find_frames(
                dense["cin"], n_mels=n_mels, widths=widths, downsample=ds
            )
        except ValueError as e:
            errs.append(str(e))
            continue
        matches.append((ds, widths, t))
    if probed_frames is not None:
        probe_hits = [m for m in matches if m[2] == probed_frames]
        if not probe_hits:
            raise UnsupportedLayerError(
                f"no downsampling hypothesis reproduces the module's probed "
                f"target_frames={probed_frames} (candidates: "
                f"{[(ds, t) for ds, _, t in matches] or errs})"
            )
        matches = probe_hits
    if not matches:
        raise UnsupportedLayerError(
            "no downsampling hypothesis explains the dense layer: "
            + "; ".join(errs)
        )
    if len(matches) > 1:
        alt = ", ".join(f"{ds} (target_frames={t})" for ds, _, t in matches[1:])
        # a warning, not a print: library consumers can filter/capture it,
        # and stdout-parsing callers don't get an unannounced extra line
        # (the ingest-encoder CLI re-surfaces it on stdout)
        warnings.warn(
            f"ambiguous checkpoint: picking downsample={matches[0][0]!r} "
            f"(target_frames={matches[0][2]}); the weights also fit {alt}. "
            "Pass --downsample (or ingest the pickled module, whose probe "
            "disambiguates) if this is wrong.",
            stacklevel=2,
        )
    ds, widths, t = matches[0]
    return VAEConfig(
        latent_dim=latent_dim,
        widths=tuple(widths),
        dense_width=dense["out"],
        groups=int(groups),
        input_hw=(t, n_mels),
        conv_padding="TORCH",
        gn_eps=1e-5,
        norm=norm,
        downsample=ds,
    )


def _find_int_key(node: Any, names: Sequence[str]) -> Optional[int]:
    if isinstance(node, Mapping):
        for k, v in node.items():
            if k in names and isinstance(v, int):
                return v
            found = _find_int_key(v, names)
            if found is not None:
                return found
    elif isinstance(node, (list, tuple)):
        for v in node:
            found = _find_int_key(v, names)
            if found is not None:
                return found
    return None


# canonical ceil-halving bottleneck formula lives next to the architecture
bottleneck_for = _vae_bottleneck_for


def auto_find_frames(
    in_features: int,
    *,
    n_mels: int,
    widths: Sequence[int],
    start: int = 8,
    max_frames: int = 4096,
    step: int = 1,
    downsample: str = "stride",
) -> int:
    """Find target_frames such that the flattened bottleneck matches the dense
    layer's in_features — the reference discovers this by re-running the
    encoder with a forward-pre-hook per candidate (``ref:07:355-409``); here
    the downsampling chain is known, so each candidate is one multiply.
    ``downsample``: "stride" (ceil halving) or "avgpool" (floor halving)."""
    n_blocks, c_last = len(widths), widths[-1]
    for frames in range(max(8, start), max(start, max_frames) + 1, max(1, step)):
        bt, bm = bottleneck_for(frames, n_mels, n_blocks, downsample)
        if bt * bm * c_last == in_features:
            return frames
    raise ValueError(
        f"no target_frames in [{start}, {max_frames}] gives dense in_features="
        f"{in_features} (n_mels={n_mels}, widths={list(widths)}, "
        f"downsample={downsample}); is n_mels right?"
    )


def probe_frames_with_hook(
    module,
    *,
    n_mels: int,
    start: int = 8,
    max_frames: int = 4096,
) -> int:
    """Discover target_frames by RUNNING an opaque torch module — the
    reference's probe, verbatim in strategy (``ref:07_encode_wav_to_latent
    .py:316-409``): register a forward-pre-hook on the first ``nn.Linear``,
    feed ``zeros[1, 1, T, n_mels]`` (the reference's mel input layout), and
    read the last-dim width F(T) the hook captures (the reference's
    ``inp.shape[-1]`` with the leading dims collapsed into N > 0,
    ``ref:07:331-343`` — so a per-position Linear over ``[B, T', F']``
    compares F', not T'·F'). F(T) is nondecreasing in T, so an exponential
    bracket + bisection finds the smallest T with F(T) == linear.in_features
    in O(log) tiny forwards.

    This works on ANY architecture torch can run — AvgPool chains, exotic
    downsampling, whatever — unlike the closed-form :func:`auto_find_frames`
    which assumes the known ceil-halving conv chain. Used by
    :func:`ingest_foreign_checkpoint` as a cross-check whenever the
    checkpoint is a runnable pickled module, and available directly for
    modules outside the ingest vocabulary.
    """
    import torch

    lin = next(
        (m for m in module.modules() if isinstance(m, torch.nn.Linear)), None
    )
    if lin is None:
        raise UnsupportedLayerError("module has no nn.Linear to probe")
    target = int(lin.in_features)
    captured: dict = {}

    def hook(mod, inp):
        x = inp[0]
        f = int(x.shape[-1])
        n = int(x.numel()) // f if f else 0
        if n > 0:
            captured["f"] = f

    handle = lin.register_forward_pre_hook(hook)
    try:
        module.eval()

        def f_of(t: int) -> Optional[int]:
            captured.clear()
            try:
                with torch.no_grad():
                    module(torch.zeros(1, 1, t, n_mels))
            except Exception:
                # a shape error PAST the linear (or at it) still leaves the
                # hook's capture valid — the reference tolerates the same
                pass
            return captured.get("f")

        # exponential bracket: find hi with F(hi) >= target
        lo, hi = max(8, start), max(8, start)
        while hi <= max_frames:
            f = f_of(hi)
            if f is not None and f >= target:
                break
            lo, hi = hi, hi * 2
        else:
            raise ValueError(
                f"no target_frames in [{start}, {max_frames}] reaches the "
                f"probed linear's in_features={target} (n_mels={n_mels})"
            )
        # F(T) is nondecreasing, so bisect the bracket for the FIRST T with
        # F(T) >= target (a failed forward / no capture means T is too small
        # — go right), then require equality: if the first such T overshoots,
        # no T hits target exactly. O(log) forwards vs the old linear scan,
        # same smallest-match convention.
        hi = min(hi, max_frames)
        while lo < hi:
            mid = (lo + hi) // 2
            f = f_of(mid)
            if f is not None and f >= target:
                hi = mid
            else:
                lo = mid + 1
        if f_of(lo) == target:
            return lo
        raise ValueError(
            f"probe bracket never hit in_features={target} "
            f"exactly (n_mels={n_mels}) — is n_mels right?"
        )
    finally:
        handle.remove()


def convert_dense_from_nchw_flatten(w, b, *, c: int, h: int, wd: int) -> Dict[str, Any]:
    """A torch net flattens NCHW (index order c,h,w); the flax encoder
    flattens NHWC (h,w,c). Reorder the dense kernel's input dimension so the
    same features land on the same weights."""
    W = np.asarray(w.detach().cpu().numpy() if hasattr(w, "detach") else w, np.float32)
    W = W.reshape(W.shape[0], c, h, wd).transpose(0, 2, 3, 1).reshape(W.shape[0], -1)
    bias = np.asarray(b.detach().cpu().numpy() if hasattr(b, "detach") else b, np.float32)
    return {"kernel": W.T, "bias": bias}


def _to_np32(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _fold_conv(conv: Dict[str, Any], *, bn_eps: float) -> Tuple[np.ndarray, np.ndarray]:
    """(torch-layout W [O,I,3,3], bias [O]) with the conv's eval-mode
    BatchNorm folded in: y = ((x*W + b) − μ)/√(σ²+eps)·γ + β is affine per
    out-channel, so W' = W·s, b' = (b − μ)·s + β with s = γ/√(σ²+eps).
    Bias-less convs (the norm carries the offset) get b = 0; affine-less BN
    gets γ = 1, β = 0. GroupNorm is NOT foldable (it normalizes by runtime
    group statistics) and is handled as a real layer by the caller."""
    W = _to_np32(conv["w"])
    b = _to_np32(conv["b"]) if conv["b"] is not None else np.zeros(W.shape[0], np.float32)
    norm = conv["norm"]
    if norm is not None and norm["kind"] == "bn":
        mean = _to_np32(norm["mean"])
        var = _to_np32(norm["var"])
        gamma = _to_np32(norm["gamma"]) if norm["gamma"] is not None else np.ones_like(mean)
        beta = _to_np32(norm["beta"]) if norm["beta"] is not None else np.zeros_like(mean)
        s = gamma / np.sqrt(var + bn_eps)
        W = W * s[:, None, None, None]
        b = (b - mean) * s + beta
    return W, b


def map_foreign_state_dict(
    sd: Mapping[str, Any], cfg: VAEConfig, *, bn_eps: float = 1e-5
) -> Dict[str, Any]:
    """Map ANY feed-forward conv/norm/linear state_dict onto ConvVAEEncoder
    params purely by shape + registration order — no name conventions
    (``parse_layer_stream`` raises a named UnsupportedLayerError for
    anything outside the vocabulary).

    Expected layer stream (names free): per block i a stride-2 and a
    stride-1 3x3 conv, each optionally biased and followed by GroupNorm
    (kept as params; ``cfg.norm='group'``), BatchNorm2d (FOLDED into the
    conv weights — eval-mode BN is a per-channel affine; ``cfg.norm='none'``)
    or nothing; then dense [dw, flat]+[dw] (NCHW-flatten order, reordered
    here to the NHWC flatten the flax encoder uses); then head_mu and
    optionally head_logvar [D, dw]+[D] (mu first — the reference probes
    z/mu first, ``ref:map_detector_core.py:279-288``). Single-head
    checkpoints get a zero logvar head (unused for deterministic latents).
    ``bn_eps`` is torch BatchNorm2d's eps (1e-5 default; not stored in
    state_dicts)."""
    layers = parse_layer_stream(sd)
    convs, linears = _split_convs_and_linears(layers)
    per_block = 1 if cfg.downsample == "avgpool" else 2
    if len(convs) != per_block * len(cfg.widths):
        raise UnsupportedLayerError(
            f"{len(convs)} convs in checkpoint vs {per_block * len(cfg.widths)} "
            f"in the target architecture {tuple(cfg.widths)} "
            f"(downsample={cfg.downsample})"
        )
    expected_norm = _norm_mode(convs)
    if expected_norm != cfg.norm:
        raise UnsupportedLayerError(
            f"checkpoint norm family ({expected_norm}) does not match "
            f"cfg.norm={cfg.norm!r} — infer_vae_config_from_state_dict sets "
            "this automatically"
        )

    def check(cond: bool, msg: str):
        if not cond:
            raise UnsupportedLayerError(msg)

    params: Dict[str, Any] = {}
    cin = 1
    for i, w in enumerate(cfg.widths):
        blk: Dict[str, Any] = {}
        slots = (
            ((0, "Conv_0"),) if cfg.downsample == "avgpool"
            else ((0, "Conv_0"), (1, "Conv_1"))
        )
        for j, slot in slots:
            conv = convs[per_block * i + j]
            want_cin = cin if j == 0 else w
            check(
                (conv["out"], conv["cin"]) == (w, want_cin),
                f"conv '{conv['name']}': channels ({conv['out']},{conv['cin']}) "
                f"do not match block {i} slot {j} ({w},{want_cin})",
            )
            Wt, bt_ = _fold_conv(conv, bn_eps=bn_eps)
            blk[slot] = convert_conv(Wt, bt_)
            if cfg.norm == "group":
                n = conv["norm"]
                check(n is not None and n["kind"] == "gn",
                      f"conv '{conv['name']}' lacks the GroupNorm pair cfg.norm "
                      "requires")
                blk[f"GroupNorm_{j}"] = convert_groupnorm(n["scale"], n["bias"])
        params[f"EncoderBlock_{i}"] = blk
        cin = w
    bt, bm = bottleneck_for(*cfg.input_hw, len(cfg.widths), cfg.downsample)
    flat = bt * bm * cfg.widths[-1]
    dense = linears[0]
    check((dense["out"], dense["cin"]) == (cfg.dense_width, flat),
          f"dense '{dense['name']}': ({dense['out']},{dense['cin']}) vs expected "
          f"({cfg.dense_width},{flat})")
    params["Dense_0"] = convert_dense_from_nchw_flatten(
        dense["w"], dense["b"], c=cfg.widths[-1], h=bt, wd=bm,
    )
    heads = linears[1:]
    check(1 <= len(heads) <= 2, f"{len(heads)} head linears after the dense layer")
    for h in heads:
        check((h["out"], h["cin"]) == (cfg.latent_dim, cfg.dense_width),
              f"head '{h['name']}': ({h['out']},{h['cin']}) vs expected "
              f"({cfg.latent_dim},{cfg.dense_width})")
    params["head_mu"] = convert_linear(heads[0]["w"], heads[0]["b"])
    if len(heads) == 2:
        params["head_logvar"] = convert_linear(heads[1]["w"], heads[1]["b"])
    else:  # single-head checkpoint: embedding IS mu; logvar never used
        params["head_logvar"] = {
            "kernel": np.zeros((cfg.dense_width, cfg.latent_dim), np.float32),
            "bias": np.zeros((cfg.latent_dim,), np.float32),
        }
    return {"params": params}


# ---------------------------------------------------------------------------
# Decoder ingest (the paired artifact: ref:docs/REPRODUCE_THESIS_BASELINE.md
# :33-42 ships bird_net_vae_audio_splitted_decoder_v0/model.pt next to the
# encoder; ref:map_detector_core.py:64-76 is the models-dir contract)
# ---------------------------------------------------------------------------

def parse_decoder_stream(sd: Mapping[str, Any]) -> List[Dict[str, Any]]:
    """Classify a DECODER state_dict's tensor stream by shape + registration
    order. Vocabulary (the mirror of the encoder's): leading Linear layers
    (weight+bias), then a conv stack of 4x4 ConvTranspose2d (weight
    [Cin, Cout, 4, 4] — torch's transposed-conv layout) and/or 3x3 Conv2d
    (weight [Cout, Cin, 3, 3]), each optionally followed by bias and a
    GroupNorm pair / BatchNorm quadruple (folded later). Anything else
    raises a named UnsupportedLayerError."""
    stream = [
        (k, v, _shape_of(v))
        for k, v in sd.items()
        if "num_batches_tracked" not in k
    ]
    layers: List[Dict[str, Any]] = []
    i = 0
    while i < len(stream):
        k, v, s = stream[i]
        if len(s) == 4:
            if (s[2], s[3]) == (4, 4):
                kind, cin, out = "convt", int(s[0]), int(s[1])
            elif (s[2], s[3]) == (3, 3):
                kind, cin, out = "conv", int(s[1]), int(s[0])
            else:
                raise UnsupportedLayerError(
                    f"decoder conv '{k}' has kernel {s[2]}x{s[3]}; the decoder "
                    "vocabulary is 4x4 ConvTranspose2d + 3x3 Conv2d"
                )
            i += 1
            run: List[Tuple[str, Any]] = []
            while i < len(stream) and len(stream[i][2]) == 1:
                if stream[i][2][0] != out:
                    raise UnsupportedLayerError(
                        f"1-D tensor '{stream[i][0]}' of length {stream[i][2][0]} "
                        f"after {kind} '{k}' (out={out}) — not a bias/norm "
                        "parameter of that layer"
                    )
                run.append((stream[i][0], stream[i][1]))
                i += 1
            if len(run) > 5:
                raise UnsupportedLayerError(
                    f"{len(run)} consecutive per-channel tensors after {kind} "
                    f"'{k}' — more than one norm layer per conv is not ingestable"
                )
            has_bias = len(run) in (1, 3, 5)
            bias = run[0][1] if has_bias else None
            norm_run = run[1:] if has_bias else run
            if len(norm_run) == 0:
                norm = None
            elif len(norm_run) == 2:
                if any("running" in n for n, _ in norm_run):
                    norm = {"kind": "bn", "gamma": None, "beta": None,
                            "mean": norm_run[0][1], "var": norm_run[1][1]}
                else:
                    norm = {"kind": "gn", "scale": norm_run[0][1], "bias": norm_run[1][1]}
            elif len(norm_run) == 4:
                norm = {"kind": "bn", "gamma": norm_run[0][1], "beta": norm_run[1][1],
                        "mean": norm_run[2][1], "var": norm_run[3][1]}
            else:
                raise UnsupportedLayerError(
                    f"cannot classify the {len(norm_run)} per-channel tensors "
                    f"after {kind} '{k}' (expected GroupNorm pair or BatchNorm "
                    "quadruple)"
                )
            layers.append({"kind": kind, "name": k, "w": v, "b": bias,
                           "out": out, "cin": cin, "norm": norm})
        elif len(s) == 2:
            o = s[0]
            if (
                i + 1 >= len(stream)
                or len(stream[i + 1][2]) != 1
                or stream[i + 1][2][0] != o
            ):
                raise UnsupportedLayerError(
                    f"linear '{k}' {s} has no bias tensor following it — "
                    "bias-less linears are outside the ingest vocabulary"
                )
            layers.append({"kind": "linear", "name": k, "w": v,
                           "b": stream[i + 1][1], "out": int(o), "cin": int(s[1])})
            i += 2
        elif len(s) == 1:
            raise UnsupportedLayerError(
                f"per-channel tensor '{k}' (length {s[0]}) with no preceding "
                "conv to attach to"
            )
        else:
            raise UnsupportedLayerError(
                f"tensor '{k}' has rank {len(s)} (shape {s}) — not a decoder "
                "Linear/ConvTranspose2d/Conv2d/norm parameter"
            )
    return layers


def infer_decoder_spec_from_state_dict(
    sd: Mapping[str, Any],
    *,
    n_mels: int = 64,
    groups: Optional[int] = None,
    yaml_cfg: Optional[Mapping[str, Any]] = None,
):
    """Shape-derived :class:`~anuraxla_torch.models.vae.DecoderSpec`.

    Stream must be linears-then-convs (the reverse of the encoder). The
    upsampling reading comes from kernel sizes: any 4x4 layer is a x2
    ConvTranspose step ("convt"); in an all-3x3 stack every conv EXCEPT the
    final output conv is preceded by a nearest x2 upsample ("upconv" — the
    mirror of the avgpool encoder family, where every conv is followed by a
    pool). The bottleneck solves in closed form (the decoder-side
    auto_find_frames): W0 = n_mels / 2^n_up, H0 = flat / (C*W0) — both must
    divide exactly or the state_dict does not decode to [*, n_mels] mels."""
    layers = parse_decoder_stream(sd)
    kinds = [l["kind"] for l in layers]
    n_lin = kinds.count("linear")
    if n_lin == 0 or n_lin == len(layers):
        raise UnsupportedLayerError(
            f"decoder stream has {n_lin} linear and {len(layers) - n_lin} conv "
            "layers (need a linear head THEN a conv stack)"
        )
    first_conv = next(j for j, k in enumerate(kinds) if k != "linear")
    late_linear = next(
        (layers[j]["name"] for j in range(first_conv, len(kinds))
         if kinds[j] == "linear"), None,
    )
    if late_linear is not None:
        raise UnsupportedLayerError(
            f"linear '{late_linear}' appears after a conv layer — only "
            "linears-then-conv-stack feed-forward decoders are ingestable"
        )
    linears = layers[:n_lin]
    stack = layers[n_lin:]
    for a, b in zip(linears[:-1], linears[1:]):
        if b["cin"] != a["out"]:
            raise UnsupportedLayerError(
                f"linear '{b['name']}' in={b['cin']} does not chain from "
                f"'{a['name']}' out={a['out']}"
            )
    cin = stack[0]["cin"]
    for a, b in zip(stack[:-1], stack[1:]):
        if b["cin"] != a["out"]:
            raise UnsupportedLayerError(
                f"{b['kind']} '{b['name']}' in={b['cin']} does not chain from "
                f"'{a['name']}' out={a['out']}"
            )

    tail_norm = stack[-1]["norm"]
    if tail_norm is not None and tail_norm["kind"] == "gn":
        # a trailing BatchNorm folds into the output conv's weights, but a
        # GroupNorm is data-dependent — DecoderSpec has no norm slot after
        # the output conv, so dropping it would silently change the recon
        raise UnsupportedLayerError(
            f"decoder output conv '{stack[-1]['name']}' is followed by a "
            "GroupNorm — a normalized output layer is outside the decoder "
            "ingest vocabulary (the spec grammar ends with a bare conv)"
        )
    if any(l["kind"] == "convt" for l in stack):
        spec_stack = tuple((l["kind"], l["out"]) for l in stack)
    else:
        if len(stack) < 2:
            raise UnsupportedLayerError(
                "an all-3x3 decoder stack needs at least one upsampling conv "
                "plus the output conv"
            )
        spec_stack = tuple(
            ("upconv" if j < len(stack) - 1 else "conv", l["out"])
            for j, l in enumerate(stack)
        )
    n_up = sum(1 for kind, _ in spec_stack if kind in ("convt", "upconv"))
    flat = linears[-1]["out"]
    if n_mels % (2**n_up) != 0:
        raise UnsupportedLayerError(
            f"n_mels={n_mels} is not divisible by 2^{n_up} (the stack's "
            "upsampling factor) — wrong n_mels or out-of-vocabulary stack"
        )
    w0 = n_mels // (2**n_up)
    if flat % (cin * w0) != 0:
        raise UnsupportedLayerError(
            f"bottleneck does not solve: flat={flat} is not divisible by "
            f"C*W0={cin}*{w0} (n_mels={n_mels}, 2^n_up={2**n_up})"
        )
    h0 = flat // (cin * w0)
    norm = _norm_mode(stack[:-1]) if len(stack) > 1 else "none"
    if groups is None:
        groups = _find_int_key(yaml_cfg or {}, ("num_groups", "groups")) or 8
    return DecoderSpec(
        latent_dim=linears[0]["cin"],
        dense_widths=tuple(l["out"] for l in linears),
        bottleneck_hw=(h0, w0),
        bottleneck_c=cin,
        stack=spec_stack,
        norm=norm,
        groups=int(groups),
        gn_eps=1e-5,
    )


def convert_convtranspose(w, b) -> Dict[str, Any]:
    """torch ConvTranspose2d weight [Cin, Cout, kh, kw] -> flax ConvTranspose
    kernel [kh, kw, Cin, Cout] with the spatial dims FLIPPED: torch's
    transposed conv is the gradient of a correlation (flipped kernel), flax's
    lax.conv_transpose correlates the kernel as-is — measured identity to
    6e-8 for k4 s2 p1 vs flax SAME."""
    W = _to_np32(w)[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    return {"kernel": np.ascontiguousarray(W),
            "bias": _to_np32(b) if b is not None else np.zeros(W.shape[-1], np.float32)}


def convert_dense_to_nchw_reshape(w, b, *, c: int, h: int, wd: int) -> Dict[str, Any]:
    """The torch decoder's last linear feeds a view(B, C, H, W); the flax
    decoder reshapes to (H, W, C). Reorder the OUTPUT rows so the same
    features land in the same spatial/channel positions (the output-side
    mirror of convert_dense_from_nchw_flatten)."""
    W = _to_np32(w)  # [C*H*W, in] in torch (c,h,w) output order
    W = W.reshape(c, h, wd, W.shape[1]).transpose(1, 2, 0, 3).reshape(-1, W.shape[1])
    bias = _to_np32(b).reshape(c, h, wd).transpose(1, 2, 0).reshape(-1)
    return {"kernel": np.ascontiguousarray(W.T), "bias": np.ascontiguousarray(bias)}


def _fold_convtranspose(layer: Dict[str, Any], *, bn_eps: float):
    """BN folding for a ConvTranspose2d: out-channels live on dim 1 of the
    torch weight [Cin, Cout, kh, kw]; same affine algebra as _fold_conv."""
    W = _to_np32(layer["w"])
    b = _to_np32(layer["b"]) if layer["b"] is not None else np.zeros(W.shape[1], np.float32)
    norm = layer["norm"]
    if norm is not None and norm["kind"] == "bn":
        mean = _to_np32(norm["mean"])
        var = _to_np32(norm["var"])
        gamma = _to_np32(norm["gamma"]) if norm["gamma"] is not None else np.ones_like(mean)
        beta = _to_np32(norm["beta"]) if norm["beta"] is not None else np.zeros_like(mean)
        s = gamma / np.sqrt(var + bn_eps)
        W = W * s[None, :, None, None]
        b = (b - mean) * s + beta
    return W, b


def map_foreign_decoder_state_dict(
    sd: Mapping[str, Any], spec, *, bn_eps: float = 1e-5
) -> Dict[str, Any]:
    """Foreign decoder state_dict -> the JAX package's IngestedDecoder tree
    (numpy; shape/order based, like map_foreign_state_dict). GroupNorms are kept as params;
    BatchNorms fold into the preceding layer's weights."""
    layers = parse_decoder_stream(sd)
    n_lin = len(spec.dense_widths)
    linears = layers[:n_lin]
    stack = layers[n_lin:]
    if len(stack) != len(spec.stack):
        raise UnsupportedLayerError(
            f"{len(stack)} stack layers in checkpoint vs {len(spec.stack)} in "
            "the spec"
        )
    if stack and stack[-1]["norm"] is not None and stack[-1]["norm"]["kind"] == "gn":
        raise UnsupportedLayerError(
            f"decoder output conv '{stack[-1]['name']}' is followed by a "
            "GroupNorm, which the spec grammar cannot represent (it would be "
            "silently dropped)"
        )
    params: Dict[str, Any] = {}
    for i, lin in enumerate(linears[:-1]):
        params[f"Dense_{i}"] = convert_linear(lin["w"], lin["b"])
    h, wd = spec.bottleneck_hw
    params[f"Dense_{n_lin - 1}"] = convert_dense_to_nchw_reshape(
        linears[-1]["w"], linears[-1]["b"], c=spec.bottleneck_c, h=h, wd=wd
    )
    for i, (layer, (kind, w)) in enumerate(zip(stack, spec.stack)):
        if layer["out"] != w:
            raise UnsupportedLayerError(
                f"stack layer '{layer['name']}' out={layer['out']} vs spec "
                f"width {w} at position {i}"
            )
        if layer["kind"] == "convt":
            Wt, bt_ = _fold_convtranspose(layer, bn_eps=bn_eps)
            params[f"Layer_{i}"] = convert_convtranspose(Wt, bt_)
        else:
            Wt, bt_ = _fold_conv(layer, bn_eps=bn_eps)
            params[f"Layer_{i}"] = convert_conv(Wt, bt_)
        if i < len(stack) - 1 and spec.norm == "group":
            n = layer["norm"]
            if n is None or n["kind"] != "gn":
                raise UnsupportedLayerError(
                    f"stack layer '{layer['name']}' lacks the GroupNorm pair "
                    "spec.norm requires"
                )
            params[f"Norm_{i}"] = convert_groupnorm(n["scale"], n["bias"])
    return {"params": params}


def ingest_foreign_decoder(
    pt_path: str | Path,
    yaml_path: str | Path | None = None,
    *,
    n_mels: int = 64,
    groups: Optional[int] = None,
    bn_eps: float = 1e-5,
):
    """torch decoder checkpoint (+optional Hydra YAML) -> (DecoderSpec, the
    port's ``IngestedDecoder`` state_dict, meta). If the checkpoint is a
    runnable pickled module, its real forward on zeros validates the
    inferred output shape (the decoder-side analogue of the encoder's
    forward-hook probe cross-check)."""
    import torch

    ckpt = torch.load(str(pt_path), map_location="cpu", weights_only=False)
    sd = split_model_and_state(ckpt)
    yaml_cfg = load_yaml_cfg(yaml_path) if yaml_path else None
    spec = infer_decoder_spec_from_state_dict(
        sd, n_mels=n_mels, groups=groups, yaml_cfg=yaml_cfg
    )
    if isinstance(ckpt, torch.nn.Module):
        try:
            with torch.no_grad():
                out = ckpt.eval()(torch.zeros(1, spec.latent_dim))
            got = tuple(out.shape[-2:])
        except Exception:
            got = None
        if got is not None and got != spec.out_hw:
            raise UnsupportedLayerError(
                f"the pickled decoder reconstructs {got}, but the shape "
                f"inference says {spec.out_hw} (n_mels={n_mels}) — wrong "
                "n_mels or out-of-vocabulary upsampling"
            )
    params = map_foreign_decoder_state_dict(sd, spec, bn_eps=bn_eps)
    state = state_from_jax(params, ingested_decoder_slots(spec))
    meta = {
        "source": str(pt_path),
        "yaml": str(yaml_path) if yaml_path else None,
        "out_hw": list(spec.out_hw),
        "norm": spec.norm,
        "n_tensors": len([k for k in sd if "num_batches_tracked" not in k]),
    }
    return spec, state, meta


# ---------------------------------------------------------------------------
# End-to-end ingest
# ---------------------------------------------------------------------------

def ingest_foreign_checkpoint(
    pt_path: str | Path,
    yaml_path: str | Path | None = None,
    *,
    n_mels: int = 64,
    groups: Optional[int] = None,
    bn_eps: float = 1e-5,
    downsample: Optional[str] = None,
) -> Tuple[VAEConfig, Dict[str, Any], Dict[str, Any]]:
    """torch checkpoint (+optional Hydra YAML) -> (VAEConfig, the port's
    encoder state_dict, meta). The YAML contributes hyperparameter hints (groups); architecture,
    norm family (GroupNorm kept / BatchNorm folded / norm-free) and
    target_frames come from the state_dict shapes. ``downsample`` forces
    the stride/avgpool reading for ambiguous bare state_dicts; runnable
    pickled modules are probed FIRST (ref:07:316-409) and the probe
    disambiguates + validates the shape inference."""
    import torch

    ckpt = torch.load(str(pt_path), map_location="cpu", weights_only=False)
    sd = split_model_and_state(ckpt)
    yaml_cfg = load_yaml_cfg(yaml_path) if yaml_path else None
    probed: Optional[int] = None
    if isinstance(ckpt, torch.nn.Module):
        try:
            probed = probe_frames_with_hook(ckpt, n_mels=n_mels)
        except Exception:
            probed = None  # unprobeable module: fall back to shapes alone
    try:
        cfg = infer_vae_config_from_state_dict(
            sd, n_mels=n_mels, groups=groups, yaml_cfg=yaml_cfg,
            downsample=downsample, probed_frames=probed,
        )
    except (UnsupportedLayerError, ValueError) as e:
        if probed is not None:
            # the module RUNS even though its weights are outside the ingest
            # vocabulary — the error carries the one fact a user needs to
            # wire it up manually
            raise UnsupportedLayerError(
                f"{e} — the pickled module itself runs (forward-hook probe: "
                f"target_frames={probed} at n_mels={n_mels}), but its "
                "architecture is outside the ingest vocabulary"
            ) from e
        raise
    state = encoder_state_from_jax(map_foreign_state_dict(sd, cfg, bn_eps=bn_eps), cfg)
    meta = {
        "source": str(pt_path),
        "yaml": str(yaml_path) if yaml_path else None,
        "target_frames": cfg.input_hw[0],
        "norm": cfg.norm,
        "downsample": cfg.downsample,
        "n_tensors": len([k for k in sd if "num_batches_tracked" not in k]),
    }
    return cfg, state, meta
