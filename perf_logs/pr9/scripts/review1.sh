#!/bin/bash
# chip_smoke.py once (the training phase's card-vs-CPU checks and
# times), the card's train-step test, and the card's tolerance readings.
set -u
out=chiprun_out/pr9
mkdir -p $out
python3 chip_smoke.py > $out/review1_smoke.log 2>&1; echo "smoke rc=$?"
python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q -k train_steps \
  > $out/review1_cuda_tests.log 2>&1; echo "cuda tests rc=$?"; tail -15 $out/review1_cuda_tests.log
python perf_logs/pr9/scripts/train_tolerances.py card > $out/review1_tolerances.log 2>&1; echo "tolerances rc=$?"
cat $out/review1_tolerances.log
grep -E "^\[done\]|^\{\"ok\"|train-path\]|\[times\] train step|mel stream a batch|Error|error" $out/review1_smoke.log | cut -c1-700
tail -5 $out/review1_smoke.log | cut -c1-300
