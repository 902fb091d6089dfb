#!/bin/bash
# the final proof: the committed tree (git archive, unpacked in _proof/final) on the card
mkdir -p chiprun_out/pr12
out=$PWD/chiprun_out/pr12
cd _proof/final
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 chip_smoke.py > $out/final_proof.log 2> $out/final_proof.err
echo "chip_smoke rc=$?"
tail -3 $out/final_proof.log | cut -c1-300
grep "\[pipeline\]\|\[times\] pipeline\|all phases passed" $out/final_proof.log | cut -c1-1200
python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q > $out/final_cuda_tests.log 2>&1
echo "card tests rc=$?"; tail -2 $out/final_cuda_tests.log
mkdir -p "${TMPDIR:-/tmp}/alone" && cp chip_smoke.py "${TMPDIR:-/tmp}/alone/" && (cd "${TMPDIR:-/tmp}/alone" && python3 chip_smoke.py > /dev/null 2>&1; echo "alone rc=$?")
CUDA_VISIBLE_DEVICES= python3 chip_smoke.py > /dev/null 2>&1; echo "card hidden rc=$?"
