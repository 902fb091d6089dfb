#!/bin/bash
# chip_smoke.py on the parent commit at seed 19 (its parallel phase's sharded train step failed there on
# this tree) and on this tree at seed 0. From the root of a checkout, with the parent unpacked in
# _proof/pr19/head and this tree in _proof/pr19/review (git archive); outputs in chiprun_out/pr19/call6/.
ROOT=$(pwd); O=$ROOT/chiprun_out/pr19/call6; mkdir -p "$O"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$O/card.txt"
for side in head:19 review:0; do
  d=${side%%:*}; s=${side##*:}
  (cd "$ROOT/_proof/pr19/$d" && timeout 1000 python chip_smoke.py --seed "$s" > "$O/smoke_${d}_$s.out" 2> "$O/smoke_${d}_$s.err")
  echo "chip_smoke $d seed $s rc=$?"; grep -E '^\[rank0\]: AssertionError|^\[rank0\]: Mismatched|^\[rank0\]: Max|^\[rank0\]: encoder' "$O/smoke_${d}_$s.err" | head -5
  grep -E '^\[parallel\] sharded train steps|^\[kernel-vs-plain\] mel_power_ct_hop32 ast|^\[times\] mel_power_ct_hop32|^\[ast-path\]|^\[done\]' "$O/smoke_${d}_$s.out" | cut -c1-900
done
