"""What a run may load and where it may run: nothing of JAX or the JAX
package in a run's process (top-level module names compared whole, since
`pcfa_tpu_torch` begins with `pcfa_tpu`), nothing of the program in the
reference, and no result without a card."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pcfa_tpu"}

_RUN = f"""
import sys, time
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
import torch
torch.set_num_threads(1)
sys.path.insert(0, {str(BENCH / 'tests')!r})
from conftest import tiny_cell
import harness
out = harness.run(tiny_cell("pwcnet-pcfa-kitti-b1", steps=2), 3, 0.0, True,
                  torch.device("cpu"), time.perf_counter())
assert out["attempted"] >= 1
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PCFA_")}
    env["PYTHONPATH"] = ""
    return env


def test_a_run_loads_nothing_of_jax():
    proc = subprocess.run([sys.executable, "-c", _RUN], capture_output=True,
                          text=True, timeout=600, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    top = set(ast.literal_eval(proc.stdout.strip().splitlines()[-1]))
    assert "pcfa_tpu_torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in FORBIDDEN | {"pcfa_tpu_torch"}, (path, n)


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "raft-pcfa-kitti-b2", "--seed", "4294967311", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        env=_env(), cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "raft-pcfa-kitti-b2", "--seed", "5", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, env=_env(),
        cwd=tmp_path)
    assert proc.returncode != 0
    assert not any(line.startswith("{") and "correct" in json.loads(line)
                   for line in proc.stdout.splitlines())
