#!/usr/bin/env bash
# Radial 2 dB floor probe (the port of scripts/drive_radial_2db.sh): fit
# radial with --augment-noise-db 14,8,5,2 and re-sweep clean,5,2,0. Two risks
# this measures: (a) the 2 dB-noised training latents may inflate rk enough
# to cost clean/5 dB accuracy, (b) at some SNR the noised cluster spread
# swallows the inter-class margin and no single radius works. Every step runs
# on DEVICE_DEFAULT (cuda unless set to cpu).
# Usage: cd <fitted project dir>; bash <repo>/anuraxla_torch/scripts/drive_radial_2db.sh
set -euo pipefail
HERE="$(cd "$(dirname "$0")" && pwd)"
# shellcheck source=_env.sh
source "$HERE/_env.sh"

VAL=latent_space_exploration/val_chunks
TRAIN=latent_space_exploration/train_chunks
PERF=(--serving-tier balanced --transfer-int16 --device "$DEVICE_DEFAULT")

echo "=== radial aug-14,8,5,2 q_in 0.99 fit ==="
$ANURAXLA fit-radial --root "$TRAIN" --q-in 0.99 --q-out 0.10 \
    --cache --augment-noise-db 14,8,5,2 "${PERF[@]}"
echo "=== radial sweep clean,5,2,0 ==="
$ANURAXLA benchmark-folder --root "$VAL" \
    --snr-sweep clean,5,2,0 --out-dir outputs/snr_radial_2db "${PERF[@]}"
echo "--- radial aug-2 curve ---"
cat outputs/snr_radial_2db/snr_curve.csv
echo "✅ radial 2 dB floor drive complete"
