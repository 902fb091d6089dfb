"""``train-vae`` on the port — train the conv VAE on a chunk tree and export
the encoder artifact (``anuraxla/cli/train_vae.py``: the same flags, the same
artifacts). WAV tree -> log-mel batches (the fused mel kernel on the card)
-> β-VAE training -> an encoder artifact every fit and evaluate command of
either package serves.

    python -m anuraxla_torch train-vae --root train_chunks --steps 2000 --ckpt-dir ckpt --save-decoder

On the card the mel stays there and goes straight into the step. On
``--device cpu`` the default kernel backend runs its plain version (the JAX
package switches to its fft backend on the CPU instead). ``--ckpt-dir``
checkpoints are the port's own format (``models.checkpoint``), not the JAX
package's orbax ones; the artifacts are shared. ``--data-parallel`` trains
over every visible card (``parallel.train_sharded``: a replica a card, the
gradients summed across them, one AdamW update); on one card it is the
single-device loop. With it, ``--resume`` and ``--init-from`` are refused, as
in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import random
from pathlib import Path

import numpy as np
import torch

from anuraxla_torch import resolve_device
from anuraxla_torch.cli.common import (
    add_batch_args, add_device_arg, add_mel_args, mel_from_args, project_root_here, resolve_tier_knobs,
)
from anuraxla_torch.constants import DEFAULT_ENCODER_DIR
from anuraxla_torch.models.checkpoint import (
    load_decoder, load_encoder, restore_train_state, save_decoder, save_encoder, save_train_state, save_vae,
)
from anuraxla_torch.models.train import TrainConfig, create_train_state, train_loop
from anuraxla_torch.models.vae import VAEConfig, encoder_params_from_vae, init_vae
from anuraxla_torch.ops.frontend import log_mel_batch, mel_to_encoder_input
from anuraxla_torch.parallel.mesh import make_mesh
from anuraxla_torch.parallel.train_sharded import train_loop_sharded
from anuraxla_torch.pipeline.dataset import iter_batches, scan_species_tree
from anuraxla_torch.utils.timing import stage_timer


def mel_batch_stream(root: Path, mel, batch_size: int, io_threads: int, epochs: int, *, parity: bool = True,
                     backend: str = "cuda", device="cuda"):
    """Endless [B, T, M, 1] mel batches on ``device`` from a chunk tree (all
    species mixed, reshuffled each epoch by one ``random.Random(0)``, as the
    reference). Rows that failed to decode, and the zero rows that pad the
    last batch, are replaced by copies of good rows so the batch shape stays
    fixed."""
    dev = resolve_device(device)
    tree = scan_species_tree(root)
    paths = [p for wavs in tree.values() for p in wavs]
    if not paths:
        raise SystemExit(f"❌ no wavs under {root}")
    rng = random.Random(0)
    for _epoch in range(epochs) if epochs > 0 else itertools.count():
        rng.shuffle(paths)
        for batch, _ in iter_batches(paths, sr=mel.sr, num_samples=mel.num_samples, batch_size=batch_size,
                                     num_threads=io_threads):
            audio = batch.audio
            if not batch.ok.all():
                good = np.flatnonzero(batch.ok)
                if good.size == 0:
                    continue
                bad = np.flatnonzero(~batch.ok)
                audio[bad] = audio[good[bad % good.size]]  # the batch's own array: no copy needed
            y = torch.from_numpy(audio).to(dev)
            yield mel_to_encoder_input(log_mel_batch(y, mel, parity=parity, backend=backend))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", required=True, type=str, help="training chunk tree (per-species subdirs)")
    p.add_argument("--out", type=str, default=None, help="encoder artifact output dir")
    p.add_argument("--ckpt-dir", type=str, default=None, help="train-state checkpoints (the port's format)")
    p.add_argument("--resume", action="store_true", help="resume from the latest checkpoint in --ckpt-dir")
    p.add_argument("--save-decoder", action="store_true",
                   help="also export the full VAE (encoder+decoder) artifact")
    p.add_argument("--init-from", type=str, default=None,
                   help="warm-start the encoder from an encoder artifact dir (either package's); the "
                   "artifact's architecture overrides --latent-dim and must match the mel frame geometry")
    p.add_argument("--init-from-decoder", type=str, default=None,
                   help="warm-start the decoder from a decoder artifact dir (ingest-decoder output); trains "
                   "the ingested decoder STRUCTURE, so its out_hw must equal the encoder input")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--epochs", type=int, default=0, help="0 = loop until --steps")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--beta", type=float, default=0.25)
    p.add_argument("--kl-warmup", type=int, default=500,
                   help="linear KL ramp 0->beta over this many steps after the delay (0 = off)")
    p.add_argument("--kl-delay", type=int, default=200,
                   help="HARD beta=0 for this many steps first (see models.train.TrainConfig)")
    p.add_argument("--latent-dim", type=int, default=128)
    p.add_argument("--bf16", action="store_true", help="bfloat16 trunk compute (params stay f32)")
    # --data-parallel comes from add_batch_args (shared with the encode CLIs)
    p.add_argument("--seed", type=int, default=0)
    add_device_arg(p)
    add_mel_args(p)
    add_batch_args(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    dtype = "bfloat16" if args.bf16 else "float32"
    project_root = project_root_here()
    mel = mel_from_args(args, duration=5.0)
    decoder_spec = None
    init_params = None
    if args.init_from:
        enc_state, vcfg = load_encoder(args.init_from)
        if tuple(vcfg.input_hw) != (mel.target_frames, mel.n_mels):
            raise SystemExit(
                f"❌ --init-from encoder consumes {vcfg.input_hw}, the mel config produces "
                f"({mel.target_frames}, {mel.n_mels}) — adjust --hop-length/--n-mels to the artifact"
            )
        vcfg = dataclasses.replace(vcfg, dtype=dtype)
        if args.latent_dim != vcfg.latent_dim:
            print(f"ℹ️ --init-from overrides latent_dim: {vcfg.latent_dim}")
        dec_state = None
        if args.init_from_decoder:
            dec_state, decoder_spec = load_decoder(args.init_from_decoder)
        _, template = init_vae(vcfg, seed=args.seed, decoder_spec=decoder_spec)
        init_params = {f"encoder.{k}": v for k, v in enc_state.items()}
        init_params.update({f"decoder.{k}": v for k, v in dec_state.items()} if dec_state is not None
                           else {k: v for k, v in template.items() if k.startswith("decoder.")})
        print(f"▶ warm start: encoder from {args.init_from}"
              + (f", decoder from {args.init_from_decoder}" if args.init_from_decoder else ", decoder random-init"))
    elif args.init_from_decoder:
        raise SystemExit("❌ --init-from-decoder requires --init-from (the decoder spec must pair with the "
                         "encoder config)")
    else:
        vcfg = VAEConfig(latent_dim=args.latent_dim, input_hw=(mel.target_frames, mel.n_mels), dtype=dtype)
    tc = TrainConfig(
        learning_rate=args.lr, beta=args.beta, total_steps=args.steps, kl_warmup_steps=args.kl_warmup,
        kl_delay_steps=args.kl_delay, batch_size=args.batch_size, seed=args.seed,
    )

    if args.transfer_int16 or args.quantize_serving or args.pre_padded_host:
        print("ℹ️ --transfer-int16/--quantize-serving/--pre-padded-host are serving-path flags; "
              "training ignores them")
    # --serving-tier picks the frontend knobs here too: train on the features
    # you will serve (the tier's encoder dtype is a serving knob; training
    # precision stays --bf16)
    knobs = resolve_tier_knobs(args)
    stream = mel_batch_stream(Path(args.root), mel, args.batch_size, args.io_threads, args.epochs,
                              parity=not knobs["fast_frontend"], backend=knobs["frontend_backend"], device=dev)

    initial_state = None
    if args.resume:
        if not args.ckpt_dir:
            raise SystemExit("❌ --resume requires --ckpt-dir")
        _, template = create_train_state(vcfg, tc, decoder_spec=decoder_spec, device=dev)
        initial_state = restore_train_state(args.ckpt_dir, template)
        print(f"▶ resumed from step {initial_state.step} in {args.ckpt_dir}")

    mesh = make_mesh(device=dev) if args.data_parallel else None
    with stage_timer("train", n_items=args.steps * args.batch_size) as t:
        try:
            if mesh is not None and mesh.shape["data"] > 1:
                if initial_state is not None:
                    raise SystemExit("❌ --resume with --data-parallel is not supported yet")
                if init_params is not None:
                    raise SystemExit("❌ --init-from with --data-parallel is not supported yet")
                _, state, metrics = train_loop_sharded(vcfg, tc, stream, num_steps=args.steps, mesh=mesh)
            else:
                _, state, metrics = train_loop(vcfg, tc, stream, num_steps=args.steps, initial_state=initial_state,
                                               decoder_spec=decoder_spec, init_params=init_params, device=dev)
        finally:
            stream.close()  # joins the decode prefetch thread
    print(f"🏁 {args.steps} steps in {t.seconds:.1f}s ({t.rate:.1f} examples/s); final {metrics}")

    out = Path(args.out) if args.out else (project_root / DEFAULT_ENCODER_DIR)
    params = state.model.state_dict()
    save_encoder(out, vcfg, encoder_params_from_vae(params))
    print(f"💾 encoder artifact: {out}")
    if args.save_decoder:
        if decoder_spec is not None:
            # an ingested decoder structure does not fit the native ConvVAE
            # artifact: save it as a standalone decoder artifact instead
            vdir = Path(str(out) + "_decoder")
            save_decoder(vdir, decoder_spec, {k[len("decoder."):]: v for k, v in params.items()
                                              if k.startswith("decoder.")})
            print(f"💾 decoder artifact (ingested structure): {vdir}")
        else:
            vdir = Path(str(out) + "_full")
            save_vae(vdir, vcfg, params)
            print(f"💾 full VAE (encoder+decoder) artifact: {vdir}")
    if args.ckpt_dir:
        save_train_state(args.ckpt_dir, state)
        print(f"💾 train state: {args.ckpt_dir}")


if __name__ == "__main__":
    main()
