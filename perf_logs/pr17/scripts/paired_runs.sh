#!/bin/bash
# Paired runs of the three cells, parent against change, in turns on one card. From the root
# of a checkout: unpack the parent commit into _proof/parent and this tree into _proof/change
# (git archive), then run this script; outputs go to chiprun_out/paired_runs/.
ROOT=$(pwd); O=$ROOT/chiprun_out/paired_runs; mkdir -p $O
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
P=$ROOT/_proof/parent; C=$ROOT/_proof/change
run() { # tree cell seed trace seconds tag
  (cd $1 && python3 perfbench/run.py --workload $2 --seed $3 --seconds $5 --trace $4) > $O/$6.out 2> $O/$6.err
  echo "$6 rc=$? $(tail -n1 $O/$6.out | cut -c1-1500)"
  grep '^diag' $O/$6.err | cut -c1-500
}
S=avgpool-scan-balanced
(cd $C && python perf_logs/pr16/scripts/span_gaps.py --workload $S --seed 3917000201) > $O/${S}_gaps_change.out 2> $O/${S}_gaps_change.err
echo "gaps_change rc=$?"; head -c 1500 $O/${S}_gaps_change.out | head -n1 | cut -c1-1500; tail -n1 $O/${S}_gaps_change.out | cut -c1-3000
run $P $S 3917000201 1 10 ${S}_traced_parent
run $P $S 3917000202 0 50 ${S}_p1
run $C $S 3917000202 0 50 ${S}_c1
run $C $S 3917000203 0 50 ${S}_c2
run $P $S 3917000203 0 50 ${S}_p2
for w in stride-folder-balanced stride-request-parity; do
  run $C $w 3917000204 0 50 ${w}_c1
  run $P $w 3917000204 0 50 ${w}_p1
  run $P $w 3917000205 0 50 ${w}_p2
  run $C $w 3917000205 0 50 ${w}_c2
done
run $C $S 3917000206 0 50 ${S}_c3
run $C $S 3917000207 0 50 ${S}_c4
(cd $C && timeout 900 python -m pytest --noconftest -p no:cacheprovider -p no:warnings -m cuda tests/test_torch_cuda.py -q) > $O/pytest_cuda.log 2>&1
echo "pytest_cuda rc=$?"; tail -n 5 $O/pytest_cuda.log
