#!/bin/bash
# after the final proof (chip_smoke.py from the git archive of the final
# tree, chiprun_out/pr13/final_proof.log): the card tests of the working
# tree, then chip_smoke.py alone and with the card hidden (each must exit
# non-zero). Run from the repository's root.
mkdir -p chiprun_out/pr13
out=$PWD/chiprun_out/pr13
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q > $out/final_cuda_tests.log 2>&1
echo "card tests rc=$?"; tail -2 $out/final_cuda_tests.log
mkdir -p "${TMPDIR:-/tmp}/alone" && cp chip_smoke.py "${TMPDIR:-/tmp}/alone/" && (cd "${TMPDIR:-/tmp}/alone" && python3 chip_smoke.py > /dev/null 2>&1; echo "alone rc=$?")
CUDA_VISIBLE_DEVICES= python3 chip_smoke.py > /dev/null 2>&1; echo "card hidden rc=$?"
