#!/usr/bin/env bash
# Fast-tier end-to-end quality characterization (the port of
# scripts/drive_fast_tier.sh): what relaxing exactness (`--serving-tier
# fast`: crop-first frontend + the mel kernel's bf16 mode + bf16 encoder
# trunk) costs END TO END with all knobs composed:
#   1. decision equivalence: benchmark the val tree under `balanced` and
#      `fast` and diff the per-file decisions (anuraxla_torch.scripts.decision_diff);
#   2. SNR sweep under the fast tier (radial + MAP);
#   3. planted-call soundscape scans (14 dB and 8 dB) under the fast tier.
# Every step runs on DEVICE_DEFAULT (cuda unless set to cpu).
# Usage: cd <fitted project dir>; bash <repo>/anuraxla_torch/scripts/drive_fast_tier.sh
set -euo pipefail
HERE="$(cd "$(dirname "$0")" && pwd)"
# shellcheck source=_env.sh
source "$HERE/_env.sh"
TMP="${TMPDIR:-/tmp}"

VAL=latent_space_exploration/val_chunks
TRAIN=latent_space_exploration/train_chunks
COMMON=(--transfer-int16 --device "$DEVICE_DEFAULT")

echo "=== [1/3] decision equivalence: balanced vs fast on the val tree ==="
$ANURAXLA benchmark-folder --root "$VAL" --serving-tier balanced \
    --out-dir outputs/tier_balanced "${COMMON[@]}"
$ANURAXLA benchmark-folder --root "$VAL" --serving-tier fast \
    --out-dir outputs/tier_fast "${COMMON[@]}"
python -m anuraxla_torch.scripts.decision_diff \
    outputs/tier_balanced/results.csv outputs/tier_fast/results.csv

echo "=== [2/3] SNR sweep under the fast tier (radial + MAP) ==="
$ANURAXLA benchmark-folder --root "$VAL" --serving-tier fast \
    --snr-sweep clean,20,14,8 --out-dir outputs/snr_radial_fast "${COMMON[@]}"
$ANURAXLA benchmark-folder-map --root "$VAL" --serving-tier fast \
    --snr-sweep clean,20,14,8 --out-dir outputs/snr_map_fast "${COMMON[@]}"

echo "=== [3/3] planted-call scans (14 dB + 8 dB) under the fast tier ==="
for SNR in 14 8; do
  SCAPE="$TMP/fast_tier_scape_${SNR}db.wav"
  [ -f "$SCAPE" ] || $ANURAXLA make-synth-data --soundscape "$SCAPE" \
      --minutes 30 --plant 0@600 --snr-db "$SNR"
  $ANURAXLA scan-soundscape --wav "$SCAPE" --serving-tier fast \
      --out outputs/scan_${SNR}db_fast.csv "${COMMON[@]}"
done

echo "=== summary ==="
echo "--- snr curves: radial fast / map fast ---"
cat outputs/snr_radial_fast/snr_curve.csv
cat outputs/snr_map_fast/snr_curve.csv
echo "--- planted windows (t=600 s) ---"
head -1 outputs/scan_14db_fast.csv
grep '^600' outputs/scan_14db_fast.csv || echo "14 dB: no detection at 600s"
grep '^600' outputs/scan_8db_fast.csv || echo "8 dB: no detection at 600s"
echo "✅ fast-tier characterization complete"
