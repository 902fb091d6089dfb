#!/bin/bash
# the whole chip_smoke.py with the pipeline phase in it
mkdir -p chiprun_out/pr12
out=$PWD/chiprun_out/pr12
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 chip_smoke.py > $out/run2.log 2> $out/run2.err; echo "chip_smoke rc=$?"
tail -3 $out/run2.log | cut -c1-3000
grep "\[pipeline\]\|\[times\] pipeline\|all phases passed" $out/run2.log | cut -c1-1500
tail -20 $out/run2.err
