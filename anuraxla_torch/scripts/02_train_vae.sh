#!/bin/bash
# Train the conv VAE and export the encoder artifact (the port of
# scripts/02_train_vae.sh). Training runs on the card by default; its kernels
# are built at first use into anuraxla_torch/_build/ and kept there, so there
# is no compilation cache to turn on. TRAIN_DEVICE=cpu trains on the host.
set -euo pipefail
source "$(dirname "$0")/_env.sh"
$ANURAXLA train-vae \
  --root "$TRAIN_CHUNKS" \
  --out "$ENCODER_DIR" \
  --steps "${TRAIN_STEPS:-$TRAIN_STEPS_DEFAULT}" \
  --batch-size "${TRAIN_BATCH:-64}" \
  --device "${TRAIN_DEVICE:-$DEVICE_DEFAULT}" \
  "$@"
