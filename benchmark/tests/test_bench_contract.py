"""`BENCHMARK.json` against the benchmark's contract, and every cell
against the files it names; adding a cell, a traffic mix, a configuration
or a metric takes new files and entries only."""

from __future__ import annotations

import json
import re
import shutil

import pytest
import torch

import cells
import harness
from conftest import BENCH, ROOT, benchmark_json, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    b = benchmark_json()
    assert set(b) == KEYS
    assert b["paths"] == ["benchmark"]
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    b = benchmark_json()
    entries = b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            if text is not None:
                assert 1 <= len(text) <= 200 and "\n" not in text \
                    and "\t" not in text, text
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in b[kind]]
        assert len(names) == len(set(names)), kind
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", [w["name"] for w in
                                  benchmark_json()["workloads"]])
def test_every_cell_resolves_its_files(name):
    cell = cells.load(benchmark_json(), name)
    cfg, traffic = cell.config, cell.traffic
    ref = cells.module("reference", cfg["reference"])
    assert hasattr(ref, cfg["reference_class"])
    assert hasattr(cells.module("attacks", traffic["attack"]), "Runner")
    for k in cfg.get("kernel_calls", {}):
        assert hasattr(cells.module("kernels", k), "bound_total_s")
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.module("metrics", m["name"]).read)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                    "pairs_per_s"}
    assert cell.per_layer
    assert cfg["limits"].get(traffic["attack"]), "no limit is set"


def test_files_under_paths_are_named_from_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
        assert not re.match(r"^bench_.*\.(json|log)$", path.name), rel
        assert not path.name.endswith("_time.txt"), rel


def test_a_new_cell_takes_files_and_entries_only(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files, with entries in BENCHMARK.json: every file already there stays
    byte for byte, the new cell resolves, runs (here, on the CPU at a small
    size) and reports the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    bench = benchmark_json()
    cfg = json.loads((BENCH / "configs" / "raft-kitti-bf16.json").read_text())
    cfg["name"] = "raft-kitti-bf16-r3"
    cfg["model"]["corr_radius"] = 3
    del cfg["kernel_calls"]
    (root / "benchmark/configs/raft-kitti-bf16-r3.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic/pcfa-published-b2.json")
                         .read_text())
    traffic["pairs"] = 3
    (root / "benchmark/traffic/pcfa-published-b3.json").write_text(
        json.dumps(traffic))
    (root / "benchmark/metrics/closures_in_window.py").write_text(
        "def read(ctx):\n    return float(sum(ctx.window.step_ends and "
        "[1]))\n")
    bench["configs"].append({"name": cfg["name"], "source": "x",
                             "file": "benchmark/configs/"
                                     "raft-kitti-bf16-r3.json",
                             "reduced": ["corr_radius"], "why": "x"})
    bench["workloads"].append({"name": "new-cell", "config": cfg["name"],
                               "traffic": "pcfa-published-b3", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "closures_in_window", "unit": "n",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["new-cell"]})
    cell = cells.load(bench, "new-cell", root)
    assert cell.traffic["pairs"] == 3
    assert "closures_in_window" in {m["name"] for m in cell.end_to_end}
    small = tiny_cell("raft-pcfa-kitti-b2")
    cell.config.update(env={}, image_hw=small.config["image_hw"])
    cell.config["model"]["iters"] = 2
    cell.traffic.update(steps=2, max_iter=4, checked_pairs=1)
    out = harness.run(cell, 7, 0.0, False, torch.device("cpu"), 0.0)
    assert out["metrics"]["closures_in_window"]["value"] == 1.0
    assert out["attempted"] >= 1 and out["failed"] == 0
    for p, data in before.items():
        assert p.read_bytes() == data, p
