# The final proof: the parent commit's tree and the `git archive` of this tree in turn (parent, change,
# change, parent), each `chip_smoke.py` in a process of its own; then, from the archive, the card
# tests, `chip_smoke.py` alone in an empty directory and with the card hidden (each must exit non-zero).
cd "$(dirname "$0")/../.."
ROOT=$(pwd)
mkdir -p chiprun_out/pr8
nvidia-smi --query-gpu=name,power.limit,clocks.sm,temperature.gpu --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
run() { (cd "$1" && timeout 700 python3 chip_smoke.py > "$ROOT/chiprun_out/pr8/$2" 2>&1; echo "$2 rc=$?"); grep -E "^\[times\] mel_power_ct_fused|^\[done\]" "chiprun_out/pr8/$2" | cut -c1-300; tail -1 "chiprun_out/pr8/$2"; }
run _proof/parent final_parent1.log
run _proof/final final_proof.log
run _proof/final final_proof2.log
run _proof/parent final_parent2.log
(cd _proof/final && timeout 600 python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q > "$ROOT/chiprun_out/pr8/final_cuda_tests.log" 2>&1; echo "cuda_tests rc=$?")
tail -2 chiprun_out/pr8/final_cuda_tests.log
D=$(mktemp -d); cp _proof/final/chip_smoke.py "$D"/; (cd "$D" && python3 chip_smoke.py; echo "alone rc=$?"); rm -rf "$D"
(cd _proof/final && CUDA_VISIBLE_DEVICES= python3 chip_smoke.py; echo "no card rc=$?")
nvidia-smi --query-gpu=name,power.limit,clocks.sm,temperature.gpu --format=csv,noheader
