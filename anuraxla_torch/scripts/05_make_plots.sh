#!/bin/bash
# Benchmark the held-out test tree with both detectors (produces the
# confusion-matrix / accuracy / NO_DETECT plots + summaries; the plots only
# where matplotlib is installed).
set -euo pipefail
source "$(dirname "$0")/_env.sh"
# test trees are optional (preflight only requires train/val) — don't let a
# missing test split abort the driver after all the expensive earlier stages
if [ -d "$TEST_CHUNKS" ]; then
  $ANURAXLA benchmark-folder --root "$TEST_CHUNKS" --config "$CONFIG_JSON" --device "$DEVICE_DEFAULT"
  $ANURAXLA benchmark-folder-map --root "$TEST_CHUNKS" --config "$CONFIG_JSON" --device "$DEVICE_DEFAULT" || \
    echo "(map benchmark skipped — run fit-map first for the MAP plots)"
else
  echo "(test benchmark skipped — $TEST_CHUNKS missing)"
fi
