#!/usr/bin/env bash
# Tiers x augmented fit composition drive (the port of
# scripts/drive_tier_scans.sh): re-drive the aug-14,8,5 q_in 0.99 operating
# point (fit by drive_5db_floor.sh) through BOTH serving tiers:
#   1. planted-call soundscape scans (14 dB and 8 dB, call at t=600 s)
#      under `balanced` and `fast`;
#   2. fast-tier SNR sweep (clean,14,8,5) on the val tree.
# Expects the 0.5 h soundscapes from drive_fast_tier.sh's make-synth-data
# step at $TMPDIR/fast_tier_scape_{14,8}db.wav (/tmp without TMPDIR) and the
# aug-14,8,5 fit already in config.json. Every step runs on DEVICE_DEFAULT
# (cuda unless set to cpu).
# Usage: cd <fitted project dir>; bash <repo>/anuraxla_torch/scripts/drive_tier_scans.sh
set -euo pipefail
HERE="$(cd "$(dirname "$0")" && pwd)"
# shellcheck source=_env.sh
source "$HERE/_env.sh"
TMP="${TMPDIR:-/tmp}"

for TIER in balanced fast; do
  for SNR in 14 8; do
    echo "=== scan ${SNR}dB tier=${TIER} ==="
    $ANURAXLA scan-soundscape --wav "$TMP/fast_tier_scape_${SNR}db.wav" \
        --serving-tier "$TIER" --out "outputs/scan_${SNR}db_${TIER}_aug5.csv" \
        --transfer-int16 --device "$DEVICE_DEFAULT"
  done
done

echo "=== fast-tier SNR sweep at the aug-14,8,5 q_in=0.99 fit ==="
$ANURAXLA benchmark-folder --root latent_space_exploration/val_chunks \
    --serving-tier fast --snr-sweep clean,14,8,5 \
    --out-dir outputs/snr_radial_fast_aug5 --transfer-int16 --device "$DEVICE_DEFAULT"

echo "--- curve ---"
cat outputs/snr_radial_fast_aug5/snr_curve.csv
for f in outputs/scan_14db_balanced_aug5.csv outputs/scan_14db_fast_aug5.csv \
         outputs/scan_8db_balanced_aug5.csv outputs/scan_8db_fast_aug5.csv; do
  echo "--- $f t=600 row + detection count ---"
  grep '^600' "$f" || echo "no 600 row"
  awk -F, 'NR>1 && $3=="True"' "$f" | wc -l
done
echo "DONE tier scans"
