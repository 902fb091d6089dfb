#!/bin/bash
# Batch-encode the chunk trees to JSONL latents.
set -euo pipefail
source "$(dirname "$0")/_env.sh"
mkdir -p "$OUTPUTS_DIR/latents"
for split in train val test; do
  dir_var="$(echo "${split}" | tr '[:lower:]' '[:upper:]')_CHUNKS"
  dir="${!dir_var}"
  [ -d "$dir" ] || { echo "skip $split ($dir missing)"; continue; }
  # --duration must match the fit/eval chunk window (config chunk_seconds,
  # default 5.0) — encode-wav's own default is the reference 07's 3.0 s,
  # which would put these latents in a different crop/standardization frame
  # than the fitted detectors
  $ANURAXLA encode-wav --root "$dir" --jsonl --device "$DEVICE_DEFAULT" \
    --duration "${CHUNK_SECONDS_DEFAULT:-5.0}" \
    > "$OUTPUTS_DIR/latents/${split}_latents.jsonl"
  echo "wrote $OUTPUTS_DIR/latents/${split}_latents.jsonl"
done
