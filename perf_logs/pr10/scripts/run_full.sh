#!/bin/bash
mkdir -p chiprun_out/pr10
python3 chip_smoke.py > chiprun_out/pr10/full1.log 2> chiprun_out/pr10/full1.err
rc=$?
echo "chip_smoke rc=$rc"
tail -4 chiprun_out/pr10/full1.log | cut -c1-3000
tail -20 chiprun_out/pr10/full1.err
exit $rc
