"""The kernels' build and chip_smoke.py's int8 / ingest phase alone on the
card, then the card tests of the int8 kernels.

    python perf_logs/pr13/scripts/int8_phase.py    (from the repository root)
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import chip_smoke  # noqa: E402

t0 = time.perf_counter()
chip_smoke.phase_build()
with tempfile.TemporaryDirectory() as tmp:
    out = chip_smoke.phase_int8_path(0, Path(tmp))
print(json.dumps({"launches": out["launches"], "times": out["times"]}, default=str))
print(f"phase {time.perf_counter() - t0:.1f} s", flush=True)
sys.exit(subprocess.call([sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-m", "cuda", "-q",
                          "tests/test_torch_cuda.py", "-k", "int8 or quantized"]))
