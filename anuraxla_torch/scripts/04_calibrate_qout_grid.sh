#!/bin/bash
# q_out calibration grid with per-run snapshots + Spearman analysis.
set -euo pipefail
source "$(dirname "$0")/_env.sh"
GRID_ROOT="${GRID_ROOT:-$OUTPUTS_DIR/qout_grid_$(date +%Y%m%d)}"
# shellcheck disable=SC2086
$ANURAXLA run-qout-grid \
  --config "$CONFIG_JSON" \
  --train-root "$TRAIN_CHUNKS" \
  --val-root "$VAL_CHUNKS" \
  --q-in "$QIN_DEFAULT" \
  --q-out-grid $QOUT_GRID \
  --max-per-class "$MAX_PER_CLASS_DEFAULT" \
  --grid-root "$GRID_ROOT" \
  --device "$DEVICE_DEFAULT" \
  --analyze \
  "$@"
