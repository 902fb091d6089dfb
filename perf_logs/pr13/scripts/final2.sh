#!/bin/bash
# The final call after review, run from the repository's root with the
# git archive of the final tree unpacked in _proof/: chip_smoke.py from the
# archive (chiprun_out/pr13/final2_proof.log), the card tests of the working
# tree, then chip_smoke.py alone and with the card hidden (each must exit
# non-zero).
out=$PWD/chiprun_out/pr13
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
(cd _proof && python3 chip_smoke.py > $out/final2_proof.log 2>&1; echo "proof rc=$?")
tail -3 $out/final2_proof.log | cut -c1-400
python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q > $out/final2_cuda_tests.log 2>&1
echo "card tests rc=$?"; tail -2 $out/final2_cuda_tests.log
mkdir -p "${TMPDIR:-/tmp}/alone" && cp chip_smoke.py "${TMPDIR:-/tmp}/alone/" && (cd "${TMPDIR:-/tmp}/alone" && python3 chip_smoke.py > /dev/null 2>&1; echo "alone rc=$?")
CUDA_VISIBLE_DEVICES= python3 chip_smoke.py > /dev/null 2>&1; echo "card hidden rc=$?"
