#!/bin/bash
# The proof of the final tree, after the fast-tier training run was added to
# chip_smoke.py: the `git archive` of the final tree (_proof/final) twice,
# then chip_smoke.py alone in an empty directory and with the card hidden
# (each must exit non-zero). final.sh's parent runs and card tests stand:
# the change touched chip_smoke.py's training phase alone.
set -u
out=chiprun_out/pr9
mkdir -p $out _proof/alone
run() {  # tree, log
  (cd _proof/$1 && python3 chip_smoke.py > ../../$out/$2 2>&1); echo "$2 rc=$?"
}
run final final2_proof.log
run final final2_proof2.log
cp _proof/final/chip_smoke.py _proof/alone/
(cd _proof/alone && python3 chip_smoke.py); echo "alone rc=$?"
(cd _proof/final && CUDA_VISIBLE_DEVICES= python3 chip_smoke.py); echo "card hidden rc=$?"
for f in final2_proof final2_proof2; do echo "== $f"; grep -E "^\[done\]|^\{\"ok\"|train step at|mel stream a batch|fast tier" $out/$f.log | cut -c1-400; done
