#!/bin/bash
# the final proof after review: the committed tree (git archive) on the card
mkdir -p chiprun_out/pr11
out=$PWD/chiprun_out/pr11
cd _proof/final2
python3 chip_smoke.py > $out/final2_proof.log 2> $out/final2_proof.err
echo "chip_smoke rc=$?"
tail -3 $out/final2_proof.log | cut -c1-300
grep "\[parallel\]\|\[times\] parallel\|all phases passed" $out/final2_proof.log | cut -c1-700
python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q > $out/final2_cuda_tests.log 2>&1
echo "card tests rc=$?"; tail -2 $out/final2_cuda_tests.log
mkdir -p /tmp/alone && cp chip_smoke.py /tmp/alone/ && (cd /tmp/alone && python3 chip_smoke.py > /dev/null 2>&1; echo "alone rc=$?")
CUDA_VISIBLE_DEVICES= python3 chip_smoke.py > /dev/null 2>&1; echo "card hidden rc=$?"
