#!/bin/bash
# The final tree on one card: chip_smoke.py (every phase; the evaluation path holds and times
# window_expand), the window expansion card tests, and one traced run of the scan cell. From the
# root of a checkout: unpack the tree into _proof/final (git archive), then run this script;
# outputs go to chiprun_out/final_check/.
ROOT=$(pwd); O=$ROOT/chiprun_out/final_check; mkdir -p $O
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
cd $ROOT/_proof/final || exit 1
timeout 1300 python3 chip_smoke.py > $O/chip_smoke.out 2> $O/chip_smoke.err
echo "chip_smoke rc=$?"; grep -E '^\[done\]|window_expand|fleet scan|scan-soundscape' $O/chip_smoke.err $O/chip_smoke.out | cut -c1-900
tail -n 3 $O/chip_smoke.err | cut -c1-2000
timeout 600 python3 -m pytest --noconftest -p no:cacheprovider -p no:warnings -m cuda tests/test_torch_cuda.py -q \
  -k "window" > $O/pytest_window.log 2>&1
echo "pytest_window rc=$?"; tail -n 3 $O/pytest_window.log
python3 perfbench/run.py --workload avgpool-scan-balanced --seed 2905113847 --seconds 10 --trace 1 \
  > $O/scan_traced.out 2> $O/scan_traced.err
echo "scan_traced rc=$? $(tail -n1 $O/scan_traced.out | cut -c1-3000)"
