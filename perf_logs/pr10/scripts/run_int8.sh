#!/bin/bash
# the int8 / ingest phase of chip_smoke.py alone, then the int8 card tests
mkdir -p chiprun_out/pr10
python - <<'PY' 2>&1 | tee chiprun_out/pr10/int8_phase.log
import sys, tempfile, time
sys.path.insert(0, ".")
from pathlib import Path
import chip_smoke as c
t0 = time.time()
with tempfile.TemporaryDirectory() as t:
    r = c.phase_int8_path(0, Path(t))
print("RESULT", r["launches"], {k: v for k, v in r["times"].items() if k in ("encoder ms", "chunks_per_s")})
print("phase s", time.time() - t0)
PY
echo "phase rc=${PIPESTATUS[0]}"
python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q -k "int8 or quantized" 2>&1 | tee chiprun_out/pr10/int8_cuda_tests.log
