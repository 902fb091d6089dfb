#!/bin/bash
# The kernels' build and chip_smoke.py's training
# phase alone (train_only.py), for the step held behind a sleep kernel.
set -u
out=chiprun_out/pr9
mkdir -p $out
python perf_logs/pr9/scripts/train_only.py > $out/review2_train_only.log 2>&1; echo "train_only rc=$?"
grep -E "train-path\] (loss|one f32|fast)|\[times\]|^build|^total|Error" $out/review2_train_only.log | cut -c1-900
