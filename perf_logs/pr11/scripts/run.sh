#!/bin/bash
# a card run of the parallel slice: the whole smoke run, then the parallel card test
mkdir -p chiprun_out/pr11
out=$PWD/chiprun_out/pr11
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
python3 chip_smoke.py > $out/run.log 2> $out/run.err; echo "chip_smoke rc=$?"
tail -3 $out/run.log | cut -c1-600
grep "\[parallel\]\|\[times\] parallel" $out/run.log | cut -c1-900
tail -5 $out/run.err
python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q -k parallel > $out/run_cuda.log 2>&1
echo "card test rc=$?"; tail -15 $out/run_cuda.log
