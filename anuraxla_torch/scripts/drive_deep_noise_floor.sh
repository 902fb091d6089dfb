#!/usr/bin/env bash
# Deep-noise floor probe (the port of scripts/drive_deep_noise_floor.sh):
# sweep both detectors at clean,5,2,0 dB:
#   1. MAP fitted with --augment-noise-db 14,8,5 (small-n preset), tau off;
#   2. radial on the aug-14,8,5 q_in 0.99 fit (refit here for
#      reproducibility from a bare tree).
# 0 dB means noise power == signal power. Every step runs on DEVICE_DEFAULT
# (cuda unless set to cpu).
# Usage: cd <fitted project dir>; bash <repo>/anuraxla_torch/scripts/drive_deep_noise_floor.sh
set -euo pipefail
HERE="$(cd "$(dirname "$0")" && pwd)"
# shellcheck source=_env.sh
source "$HERE/_env.sh"

VAL=latent_space_exploration/val_chunks
TRAIN=latent_space_exploration/train_chunks
PERF=(--serving-tier balanced --transfer-int16 --device "$DEVICE_DEFAULT")

echo "=== MAP aug-14,8,5 small-n fit ==="
$ANURAXLA fit-map --root "$TRAIN" --preset small-n \
    --augment-noise-db 14,8,5 --cache "${PERF[@]}"
echo "=== MAP sweep clean,5,2,0 ==="
$ANURAXLA benchmark-folder-map --root "$VAL" \
    --snr-sweep clean,5,2,0 --out-dir outputs/snr_map_deep "${PERF[@]}"
echo "--- MAP curve ---"
cat outputs/snr_map_deep/snr_curve.csv

echo "=== radial aug-14,8,5 q_in 0.99 fit ==="
$ANURAXLA fit-radial --root "$TRAIN" --q-in 0.99 --q-out 0.10 \
    --cache --augment-noise-db 14,8,5 "${PERF[@]}"
echo "=== radial sweep clean,5,2,0 ==="
$ANURAXLA benchmark-folder --root "$VAL" \
    --snr-sweep clean,5,2,0 --out-dir outputs/snr_radial_deep "${PERF[@]}"
echo "--- radial curve ---"
cat outputs/snr_radial_deep/snr_curve.csv
echo "✅ deep-noise floor drive complete"
