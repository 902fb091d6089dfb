"""The kernels' build and chip_smoke.py's training phase alone, on the card:
python perf_logs/pr9/scripts/train_only.py (from the repository's root)."""
import sys, tempfile, time
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parents[3]))
import numpy as np, torch
import chip_smoke as cs
t0 = time.perf_counter()
cs.phase_build()
print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
with tempfile.TemporaryDirectory() as tmp:
    r = cs.phase_train_path(0, Path(tmp))
print(r)
print(f"total {time.perf_counter() - t0:.1f} s")
