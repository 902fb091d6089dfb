set -x
ROOT=$(cd "$(dirname "$0")/../.." && pwd)
cd "$ROOT"; mkdir -p chiprun_out/pr6
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit,clocks.sm,temperature.gpu --format=csv,noheader
run() { (cd _proof/$1 && timeout 700 python3 chip_smoke.py > "$ROOT"/chiprun_out/pr6/$2 2>&1; echo "$2 rc=$?"); grep -E "^\[done\]|\[times\] (encode_paths|encode_array|fits)|tier B=1024 breakdown" chiprun_out/pr6/$2 | cut -c1-330; }
run parent final_parent1.log
run tree final_proof.log
run tree final_proof2.log
run parent final_parent2.log
(cd _proof/tree && timeout 600 python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q > "$ROOT"/chiprun_out/pr6/final_cuda_tests.log 2>&1; echo cuda_rc=$?)
tail -3 chiprun_out/pr6/final_cuda_tests.log
D=$(mktemp -d); cp _proof/tree/chip_smoke.py $D/; (cd $D && python3 chip_smoke.py; echo empty_rc=$?); rm -rf $D
(cd _proof/tree && CUDA_VISIBLE_DEVICES= python3 chip_smoke.py; echo nocard_rc=$?)
grep -E "fit-path\] (card vs|exit codes|fit_radial_tree)" chiprun_out/pr6/final_proof.log | cut -c1-400
tail -3 chiprun_out/pr6/final_proof.log | cut -c1-300
