#!/bin/bash
# The final chip call: the parent's tree and this PR's (each a `git archive`
# under _proof/), in turn, then from this PR's tree the card tests and
# chip_smoke.py alone in an empty directory and with the card hidden (each of
# the last two must exit non-zero).
set -u
out=chiprun_out/pr9
mkdir -p $out _proof/alone
python -c "import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)"
run() {  # tree, log
  (cd _proof/$1 && python3 chip_smoke.py > ../../$out/$2 2>&1); echo "$2 rc=$?"
}
run parent final_parent1.log
run final final_proof.log
run final final_proof2.log
run parent final_parent2.log
(cd _proof/final && python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q \
  > ../../$out/final_cuda_tests.log 2>&1); echo "cuda tests rc=$?"; tail -3 $out/final_cuda_tests.log
cp _proof/final/chip_smoke.py _proof/alone/
(cd _proof/alone && python3 chip_smoke.py); echo "alone rc=$?"
(cd _proof/final && CUDA_VISIBLE_DEVICES= python3 chip_smoke.py); echo "card hidden rc=$?"
for f in final_parent1 final_proof final_proof2 final_parent2; do echo "== $f"; grep -E "^\[done\]|^\{\"ok\"|train step at|mel stream a batch" $out/$f.log | cut -c1-400; done
