#!/bin/bash
# first card run of the pipeline slice: the kernels' build and chip_smoke.py's
# pipeline phase alone, then the three probes at their defaults
mkdir -p chiprun_out/pr12
out=$PWD/chiprun_out/pr12
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python perf_logs/pr12/scripts/phase10.py > $out/run1_phase10.log 2>&1; echo "phase10 rc=$?"
grep "\[pipeline\]\|\[times\] pipeline\|Error\|error" $out/run1_phase10.log | cut -c1-1500
tail -5 $out/run1_phase10.log | cut -c1-1500
for probe in encoder_variants train_step; do
  python -m anuraxla_torch.probes.$probe > $out/run1_$probe.jsonl 2>&1; echo "$probe rc=$?"
  cat $out/run1_$probe.jsonl | cut -c1-400
done
mkdir -p _proof/cold_io
df -T "$PWD/_proof/cold_io" /tmp | cat
python -m anuraxla_torch.probes.cold_io --root "$PWD/_proof/cold_io" > $out/run1_cold_io.log 2>&1; echo "cold_io rc=$?"
cat $out/run1_cold_io.log
