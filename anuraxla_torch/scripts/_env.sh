#!/bin/bash
# Shared path/parameter environment of the port's pipeline scripts — the
# port of scripts/_env.sh: the same variables with the same defaults, except
# that the commands are the port's and DEVICE_DEFAULT names the card.

# the scripts sit in anuraxla_torch/scripts/, two levels below the repo root
REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export REPO_ROOT

# The framework (REPO_ROOT) and the data project (PROJECT_ROOT) are separate:
# run the scripts from your project directory, or set PROJECT_ROOT.
export PROJECT_ROOT="${PROJECT_ROOT:-$PWD}"

export CHUNKS_ROOT="${CHUNKS_ROOT:-$PROJECT_ROOT/latent_space_exploration}"
export TRAIN_CHUNKS="${TRAIN_CHUNKS:-$CHUNKS_ROOT/train_chunks}"
export VAL_CHUNKS="${VAL_CHUNKS:-$CHUNKS_ROOT/val_chunks}"
export TEST_CHUNKS="${TEST_CHUNKS:-$CHUNKS_ROOT/test_chunks}"
export MODELS_DIR="${MODELS_DIR:-$PROJECT_ROOT/models}"
export OUTPUTS_DIR="${OUTPUTS_DIR:-$PROJECT_ROOT/outputs}"
export ENCODER_DIR="${ENCODER_DIR:-$MODELS_DIR/anuraxla_vae_encoder_v0}"
export CONFIG_JSON="${CONFIG_JSON:-$PROJECT_ROOT/config.json}"

export CHUNK_SECONDS_DEFAULT="${CHUNK_SECONDS_DEFAULT:-5.0}"
export QIN_DEFAULT="${QIN_DEFAULT:-0.95}"
export QOUT_GRID="${QOUT_GRID:-0.10 0.15 0.20 0.25}"
export MAX_PER_CLASS_DEFAULT="${MAX_PER_CLASS_DEFAULT:-400}"
# cuda: the card (the hand-written kernels); cpu: their plain PyTorch
# versions. The port has no 'auto': any other value fails the first step
# that runs (resolve_device), it never falls back to the CPU.
export DEVICE_DEFAULT="${DEVICE_DEFAULT:-cuda}"
export TRAIN_STEPS_DEFAULT="${TRAIN_STEPS_DEFAULT:-2000}"

# make the framework importable when running from a project dir
export PYTHONPATH="$REPO_ROOT${PYTHONPATH:+:$PYTHONPATH}"

ANURAXLA="python -m anuraxla_torch"
export ANURAXLA
