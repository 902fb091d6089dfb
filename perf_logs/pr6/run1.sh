set -x
cd "$(dirname "$0")/../.."; mkdir -p chiprun_out/pr6
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
which g++
timeout 1100 python3 chip_smoke.py > chiprun_out/pr6/run1_smoke.log 2>&1; echo smoke_rc=$?
tail -5 chiprun_out/pr6/run1_smoke.log
grep -E "fit-path|\[times\] (encode_paths|fits)|Error|error|Traceback" chiprun_out/pr6/run1_smoke.log | cut -c1-400 | head -60
timeout 900 python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q -x > chiprun_out/pr6/run1_cuda.log 2>&1; echo cuda_rc=$?
tail -15 chiprun_out/pr6/run1_cuda.log
