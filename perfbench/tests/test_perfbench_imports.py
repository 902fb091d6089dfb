"""Nothing the benchmark runs loads JAX or the JAX package (``anuraxla``),
compared by whole top-level module name (``anuraxla_torch`` is the port and
passes); the reference imports nothing of the port; ``run.py`` prints no
result without a card or without the port beside it."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from perfbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "anuraxla"}


def imports_of(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_sources_import_nothing_forbidden():
    for p in harness.PB.rglob("*.py"):
        assert not set(imports_of(p)) & FORBIDDEN, p
    for p in (harness.PB / "reference").rglob("*.py"):
        mods = set(imports_of(p))
        assert "anuraxla_torch" not in mods and mods <= {"__future__", "contextlib", "math", "random", "struct", "pathlib",
                                                         "typing", "numpy", "torch", "perfbench"}, (p, mods)


def test_loaded_modules_hold_no_jax():
    """Every driver, reader and the control loaded, and a cell run, in a fresh process."""
    code = (
        "import sys, io, importlib; sys.path.insert(0, %r)\n"
        "from perfbench import harness, control\n"
        "from perfbench.tests import tiny\n"
        "m = tiny.manifest()\n"
        "for w in m['workloads']: harness.driver_class(harness.load_cell(w['name'], m).kind)\n"
        "for x in m['end_to_end'] + m['per_layer']: harness.reader(x['name'])\n"
        "res, _ = tiny.run(tiny.cell('stride-request-parity'), trace=True)\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n" % str(harness.ROOT)
    ).replace("print(json", "import json; print(json")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd="/")
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "anuraxla_torch" in loaded and not loaded & FORBIDDEN


def run_py(cwd: Path, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "stride-request-parity", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run_py(harness.ROOT, env)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.PB, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
