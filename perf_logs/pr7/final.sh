set -x
ROOT=$(cd "$(dirname "$0")/.." && pwd)
cd "$ROOT"; mkdir -p chiprun_out/pr7
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit,clocks.sm,temperature.gpu --format=csv,noheader
run() { (cd _proof/tree && timeout 700 python3 chip_smoke.py > "$ROOT"/chiprun_out/pr7/$1 2>&1; echo "$1 rc=$?"); grep -E "^\[done\]|\[times\] (fleet|device sweep|run_folder)|eval-path\] (scan|device sweep|tau_grid|benchmark-folder: acc)" chiprun_out/pr7/$1 | cut -c1-400; }
run final_proof.log
run final_proof2.log
(cd _proof/tree && timeout 600 python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q > "$ROOT"/chiprun_out/pr7/final_cuda_tests.log 2>&1; echo cuda_rc=$?)
tail -3 chiprun_out/pr7/final_cuda_tests.log
D=$(mktemp -d); cp _proof/tree/chip_smoke.py $D/; (cd $D && python3 chip_smoke.py; echo empty_rc=$?); rm -rf $D
(cd _proof/tree && CUDA_VISIBLE_DEVICES= python3 chip_smoke.py; echo nocard_rc=$?)
tail -3 chiprun_out/pr7/final_proof.log | cut -c1-300
