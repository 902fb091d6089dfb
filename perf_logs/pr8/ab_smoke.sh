# parent and change, in turn, from one card: chip_smoke.py of each tree in a process of its own
cd "$(dirname "$0")/.."
ROOT=$(pwd)
mkdir -p chiprun_out/pr8
nvidia-smi --query-gpu=name,power.limit,clocks.sm,temperature.gpu --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
run() { (cd "$1" && timeout 700 python3 chip_smoke.py > "$ROOT/chiprun_out/pr8/$2" 2>&1; echo "$2 rc=$?"); grep -E "^\[times\] mel_power_ct_fused" "chiprun_out/pr8/$2" | cut -c1-260; }
run _proof/parent ab_parent1.log
run . ab_change1.log
run . ab_change2.log
run _proof/parent ab_parent2.log
nvidia-smi --query-gpu=name,power.limit,clocks.sm,temperature.gpu --format=csv,noheader
