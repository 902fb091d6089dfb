#!/bin/bash
# The AST cell's checks on one card, on a `git archive` of the tree unpacked in _proof/pr19/review:
# the hop-32 mel kernel's card tests and the AST card tests, chip_smoke.py whole (the kernel held to
# its plain version and timed at the cell's shape), the control of ast-scan-balanced on ten seeds,
# and the cell itself traced once and untraced on two seeds. Outputs go to chiprun_out/pr19/call5/.
ROOT=$(pwd); O=$ROOT/chiprun_out/pr19/call5; mkdir -p "$O"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$O/card.txt"
cd "$ROOT/_proof/pr19/review" || exit 1
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
timeout 600 python -m pytest --noconftest -p no:cacheprovider -p no:warnings -m cuda tests/test_torch_cuda.py -q \
  -k "ct_kernel_matches_split_plain or ast" > "$O/pytest_ct_ast.log" 2>&1
echo "pytest rc=$?"; tail -n 3 "$O/pytest_ct_ast.log"
timeout 1200 python chip_smoke.py --seed 19 > "$O/chip_smoke.out" 2> "$O/chip_smoke.err"
echo "chip_smoke rc=$?"; tail -n 5 "$O/chip_smoke.err"
grep -E '^\[kernel-vs-plain\] mel_power_ct_hop32|^\[times\] mel_power_ct_hop32|^\[ast-path\]|^\[done\]' "$O/chip_smoke.out" | cut -c1-900
timeout 900 python3 perfbench/control.py --workload ast-scan-balanced \
  --seeds 3190005001 3190005002 3190005003 3190005004 3190005005 3190005006 3190005007 3190005008 3190005009 3190005010 \
  > "$O/control.out" 2> "$O/control.err"
echo "control rc=$?"; cut -c1-400 "$O/control.out"
run() { # seed trace tag
  python3 perfbench/run.py --workload ast-scan-balanced --seed "$1" --seconds 10 --trace "$2" > "$O/$3.out" 2> "$O/$3.err"
  echo "$3 rc=$? $(tail -n1 "$O/$3.out" | cut -c1-2500)"
}
run 3190005101 1 ast_traced
run 3190005102 0 ast_1
run 3190005103 0 ast_2
