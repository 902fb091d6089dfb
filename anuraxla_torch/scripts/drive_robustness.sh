#!/usr/bin/env bash
# Noise-robustness measurement drive (the port of scripts/drive_robustness.sh;
# docs/ROBUSTNESS.md): from a fitted project dir (e.g. one that
# run_full_pipeline.sh has been through),
#   1. SNR-sweep both detectors on the val tree -> snr_curve.csv each
#   2. device-sweep the (q_in x q_out) grid with a 14 dB noise margin and
#      parse the recommended operating point
#   3. scan a 30-min 14 dB-SNR synthetic soundscape (planted call @600 s)
#      at the CURRENT operating point, then refit radial at the
#      recommended point and re-scan
#   4. refit with --augment-noise-db (the engineered fix), re-sweep, re-scan
# Every step runs on DEVICE_DEFAULT (cuda unless set to cpu).
# Usage: cd <project>; bash <repo>/anuraxla_torch/scripts/drive_robustness.sh [minutes] [snr_db]
set -euo pipefail
MINUTES="${1:-30}"
SNRDB="${2:-14}"
HERE="$(cd "$(dirname "$0")" && pwd)"
# shellcheck source=_env.sh
source "$HERE/_env.sh"
TMP="${TMPDIR:-/tmp}"

DEV=(--device "$DEVICE_DEFAULT")
PERF=(--frontend-backend cuda --transfer-int16 --encoder-dtype bfloat16 "${DEV[@]}")
VAL=latent_space_exploration/val_chunks
TRAIN=latent_space_exploration/train_chunks

echo "=== [1/4] SNR sweep (radial + MAP) ==="
$ANURAXLA benchmark-folder     --root "$VAL" --snr-sweep "clean,20,$SNRDB,8" \
    --out-dir outputs/snr_radial "${PERF[@]}"
$ANURAXLA benchmark-folder-map --root "$VAL" --snr-sweep "clean,20,$SNRDB,8" \
    --out-dir outputs/snr_map "${PERF[@]}"

echo "=== [2/4] noise-margin device sweep ==="
$ANURAXLA run-qout-grid --device-sweep \
    --q-in-grid 0.90 0.95 0.99 --q-out-grid 0.05 0.10 0.15 0.20 0.25 \
    --noise-margin-db "$SNRDB" "${PERF[@]}" | tee "$TMP/nm_sweep.log"
QI=$(sed -n 's/.*operating point.*q_in=\([0-9.]*\) q_out=\([0-9.]*\).*/\1/p' "$TMP/nm_sweep.log")
QO=$(sed -n 's/.*operating point.*q_in=\([0-9.]*\) q_out=\([0-9.]*\).*/\2/p' "$TMP/nm_sweep.log")
test -n "$QI" -a -n "$QO" || { echo "❌ no operating point parsed"; exit 1; }
echo "recommended: q_in=$QI q_out=$QO"

echo "=== [3/4] ${SNRDB} dB soundscape scan at the CURRENT operating point ==="
SCAPE="$TMP/robust_scape_${SNRDB}db.wav"
$ANURAXLA make-synth-data --soundscape "$SCAPE" \
    --minutes "$MINUTES" --plant 0@600 --snr-db "$SNRDB"
$ANURAXLA scan-soundscape --wav "$SCAPE" \
    --out outputs/scan_${SNRDB}db_default.csv "${PERF[@]}"

echo "=== [4/4] refit at the recommended point, re-scan ==="
cp config.json "$TMP/config_pre_margin.json"
$ANURAXLA fit-radial --root "$TRAIN" --q-in "$QI" --q-out "$QO" --cache "${DEV[@]}"
$ANURAXLA scan-soundscape --wav "$SCAPE" \
    --out outputs/scan_${SNRDB}db_margin.csv "${PERF[@]}"

echo "=== [5/5] noise-AUGMENTED refit (the engineered fix), re-sweep, re-scan ==="
$ANURAXLA fit-radial --root "$TRAIN" --q-in "$QI" --q-out "$QO" \
    --cache --augment-noise-db "$SNRDB" "${DEV[@]}"
$ANURAXLA benchmark-folder --root "$VAL" --snr-sweep "clean,20,$SNRDB,8" \
    --out-dir outputs/snr_radial_aug "${PERF[@]}"
$ANURAXLA scan-soundscape --wav "$SCAPE" \
    --out outputs/scan_${SNRDB}db_augment.csv "${PERF[@]}"

echo "=== planted-window (t=600s) rows ==="
head -1 outputs/scan_${SNRDB}db_default.csv
grep '^600' outputs/scan_${SNRDB}db_default.csv || true
grep '^600' outputs/scan_${SNRDB}db_margin.csv || true
grep '^600' outputs/scan_${SNRDB}db_augment.csv || true
echo "=== snr curves (radial, map, radial-augmented) ==="
cat outputs/snr_radial/snr_curve.csv
cat outputs/snr_map/snr_curve.csv
cat outputs/snr_radial_aug/snr_curve.csv
echo "✅ robustness drive complete (configs: $TMP/config_pre_margin.json kept)"
