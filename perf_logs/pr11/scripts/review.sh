#!/bin/bash
# a card run after review: the whole smoke run, the parallel card test, and the train-step gate probe
mkdir -p chiprun_out/pr11
out=$PWD/chiprun_out/pr11
python3 chip_smoke.py > $out/review.log 2> $out/review.err; echo "chip_smoke rc=$?"
tail -3 $out/review.log | cut -c1-400
grep "\[parallel\]\|all phases passed" $out/review.log | cut -c1-1200
tail -5 $out/review.err
python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q -k parallel > $out/review_cuda.log 2>&1
echo "card test rc=$?"; tail -15 $out/review_cuda.log
python perf_logs/pr11/scripts/train_gate.py > $out/review_train_gate.log 2>&1; echo "train_gate rc=$?"
cat $out/review_train_gate.log
