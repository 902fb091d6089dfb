#!/usr/bin/env bash
# The 5 dB radial floor (the port of scripts/drive_5db_floor.sh): does
# extending the augmented fit with a 5 dB leg move the radial floor?
#   1. fit radial --augment-noise-db 14,8,5 at two q_in settings;
#   2. SNR-sweep clean,14,8,5 after each fit;
#   3. diagnostic: per-class distance stats of the 5 dB-noised val latents
#      under the final fit (anuraxla_torch.scripts.noise_distance: is the
#      miss a threshold problem — distances just past rk — or a geometry
#      problem — noise collapses class separation?).
# Every step runs on DEVICE_DEFAULT (cuda unless set to cpu).
# Usage: cd <fitted project dir>; bash <repo>/anuraxla_torch/scripts/drive_5db_floor.sh
set -euo pipefail
HERE="$(cd "$(dirname "$0")" && pwd)"
# shellcheck source=_env.sh
source "$HERE/_env.sh"

VAL=latent_space_exploration/val_chunks
TRAIN=latent_space_exploration/train_chunks
PERF=(--serving-tier balanced --transfer-int16 --device "$DEVICE_DEFAULT")

for QI in 0.95 0.99; do
  echo "=== aug-14,8,5 fit at q_in=$QI ==="
  $ANURAXLA fit-radial --root "$TRAIN" --q-in "$QI" --q-out 0.10 \
      --cache --augment-noise-db 14,8,5 "${PERF[@]}"
  $ANURAXLA benchmark-folder --root "$VAL" \
      --snr-sweep clean,14,8,5 --out-dir "outputs/snr_radial_aug5_qi$QI" \
      "${PERF[@]}"
  echo "--- curve (q_in=$QI) ---"
  cat "outputs/snr_radial_aug5_qi$QI/snr_curve.csv"
done

echo "=== 5 dB distance diagnostic under the final fit ==="
python -m anuraxla_torch.scripts.noise_distance --device "$DEVICE_DEFAULT"
echo "✅ 5 dB floor drive complete"
