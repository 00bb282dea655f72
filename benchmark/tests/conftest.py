"""The benchmark's CPU tests: its modules import as a run imports them
(`benchmark/` and the checkout's root on the path), with one torch thread.
`tiny_cell` gives a cell of `BENCHMARK.json` at a size a CPU holds: the
published widths, 2 refinement iterations for RAFT, 128-pixel frames,
2 pairs, 3 steps of 4 L-BFGS iterations (torch's L-BFGS counts its
evaluations against 5·max_iter/4, which binds below 4 iterations). The
program runs in float32 unless a test sets the configuration's own
environment (`configured`), as a run does."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import torch  # noqa: E402

import cells  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def benchmark_json() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


#: a cell whose program fault keeps it out of BENCHMARK.json (PERF.md §7):
#: its files stay, and so do its tests
OUT_OF_BENCHMARK = {"pwcnet-pcfa-kitti-b1": ("pwcnet-kitti-bf16",
                                             "pcfa-published-b1")}


def tiny_cell(name: str, **traffic) -> cells.Cell:
    bench = benchmark_json()
    if name in OUT_OF_BENCHMARK:
        config, mix = OUT_OF_BENCHMARK[name]
        bench["configs"].append({"name": config, "file":
                                 f"benchmark/configs/{config}.json"})
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": mix, "chips": 1})
    cell = cells.load(bench, name)
    cell.config = copy.deepcopy(cell.config)
    if cell.config["net"] == "RAFT":
        cell.config["image_hw"] = [126, 132]
        cell.config["model"]["iters"] = 2
    else:
        cell.config["image_hw"] = [120, 126]
    t = dict(cell.traffic, steps=3, pairs=2, checked_pairs=2)
    if "max_iter" in t:
        t["max_iter"] = 4
    t.update(traffic)
    cell.traffic = t
    return cell


@pytest.fixture(autouse=True)
def _no_program_settings(monkeypatch):
    """Runs here take the float32 network and history: no `PCFA_*`
    setting of the caller's leaks in."""
    import os

    for key in [k for k in os.environ if k.startswith("PCFA_")]:
        monkeypatch.delenv(key)


def configured(cell: cells.Cell, monkeypatch) -> cells.Cell:
    """`cell`, with the program's environment set to the configuration's
    `PCFA_*` settings, as `run.py` sets it."""
    for key, value in cell.config["env"].items():
        monkeypatch.setenv(key, value)
    return cell
