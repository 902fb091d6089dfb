"""The kernels' build and chip_smoke.py's pipeline-driver phase alone on the
card, with the two drives that carry a ported diagnostic
(``drive_fast_tier.sh``, ``drive_5db_floor.sh``), which chip_smoke.py's own
run leaves out for time.

    python perf_logs/pr12/scripts/phase10.py    (from the repository root)
"""

import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import chip_smoke  # noqa: E402

t0 = time.perf_counter()
chip_smoke.phase_build()
with tempfile.TemporaryDirectory() as tmp:
    out = chip_smoke.phase_pipeline_path(0, Path(tmp), drives=chip_smoke.PIPELINE_DRIVES)
print(out, f"{time.perf_counter() - t0:.1f} s")
