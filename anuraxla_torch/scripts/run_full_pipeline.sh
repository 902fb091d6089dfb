#!/bin/bash
# Full pipeline driver of the port (the port of scripts/run_full_pipeline.sh):
# preflight -> normalize -> train VAE -> fit MAP -> encode latents ->
# calibrate q_out grid -> test benchmark plots, every step through
# `python -m anuraxla_torch` on DEVICE_DEFAULT (cuda unless set to cpu).
#
#   cd <project> && bash <repo>/anuraxla_torch/scripts/run_full_pipeline.sh
set -euo pipefail
source "$(dirname "$0")/_env.sh"

echo "== preflight =="
fail=0
for d in "$TRAIN_CHUNKS" "$VAL_CHUNKS"; do
  if [ ! -d "$d" ] || [ -z "$(find "$d" -name '*.wav' -print -quit 2>/dev/null)" ]; then
    echo "❌ missing or empty chunk dir: $d"
    fail=1
  fi
done
for s in 01_normalize_chunks.sh 02_train_vae.sh 03_encode_latents.sh 04_calibrate_qout_grid.sh 05_make_plots.sh; do
  [ -f "$(dirname "$0")/$s" ] || { echo "❌ missing script: $s"; fail=1; }
done
[ "$fail" -eq 0 ] || { echo "preflight failed"; exit 1; }
# seed the default config only AFTER the fail gate: an aborted preflight
# must not leave artifacts in the user's project dir
if [ ! -f "$CONFIG_JSON" ]; then
  echo "⚠️ $CONFIG_JSON missing — seeding a default (species + chunk_seconds)"
  python - "$CONFIG_JSON" <<'PY'
import json, sys
from anuraxla_torch.constants import SPECIES
json.dump({"species": list(SPECIES), "chunk_seconds": 5.0}, open(sys.argv[1], "w"), indent=2)
PY
fi
echo "✅ preflight ok"

bash "$(dirname "$0")/01_normalize_chunks.sh"
# downstream stages consume the normalized trees (reference flow: "normalized
# folders are then used for latent encoding", REPRODUCE guide §2)
export TRAIN_CHUNKS="${TRAIN_CHUNKS}_norm"
export VAL_CHUNKS="${VAL_CHUNKS}_norm"
export TEST_CHUNKS="${TEST_CHUNKS}_norm"
if [ ! -f "$ENCODER_DIR/encoder.msgpack" ]; then
  bash "$(dirname "$0")/02_train_vae.sh"
else
  echo "== encoder artifact present, skipping training (rm $ENCODER_DIR to retrain) =="
fi
# fit the MAP detector once so the MAP benchmark in step 05 has parameters.
# --preset small-n (diag + shrink 0.1): at demo scale (D=128 latents, tens
# of chunks per class) a full pooled covariance overfits so hard that the
# tau computed from train scores rejects every val chunk; the preset's
# diagonal/shrunk density generalizes. Override MAP_FIT_ARGS for real
# datasets (e.g. "--cov-structure full").
$ANURAXLA fit-map --config "$CONFIG_JSON" --root "$TRAIN_CHUNKS" \
  --max-per-class "$MAX_PER_CLASS_DEFAULT" --cache --set-tau-q 0.01 \
  ${MAP_FIT_ARGS:---preset small-n} --device "$DEVICE_DEFAULT"
bash "$(dirname "$0")/03_encode_latents.sh"
bash "$(dirname "$0")/04_calibrate_qout_grid.sh"
bash "$(dirname "$0")/05_make_plots.sh"
echo "🏁 full pipeline done — outputs under $OUTPUTS_DIR"
