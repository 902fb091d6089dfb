#!/bin/bash
# The proof of the final tree: the `git archive` of the tree
# (_proof/final) twice, the card tests, then chip_smoke.py alone in an empty
# directory and with the card hidden (each must exit non-zero).
set -u
out=chiprun_out/pr9
mkdir -p $out _proof/alone
python -c "import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)"
run() {  # tree, log
  (cd _proof/$1 && python3 chip_smoke.py > ../../$out/$2 2>&1); echo "$2 rc=$?"
}
run final final3_proof.log
run final final3_proof2.log
(cd _proof/final && python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q \
  > ../../$out/final3_cuda_tests.log 2>&1); echo "cuda tests rc=$?"; tail -3 $out/final3_cuda_tests.log
cp _proof/final/chip_smoke.py _proof/alone/
(cd _proof/alone && python3 chip_smoke.py); echo "alone rc=$?"
(cd _proof/final && CUDA_VISIBLE_DEVICES= python3 chip_smoke.py); echo "card hidden rc=$?"
for f in final3_proof final3_proof2; do echo "== $f"; grep -E "^\[done\]|^\{\"ok\"|train step at|mel stream a batch|train-path\] (loss|one f32|fast)|🏁" $out/$f.log | cut -c1-700; tail -3 $out/$f.log | cut -c1-300; done
