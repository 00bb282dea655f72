"""A cell of `BENCHMARK.json` and the files it names, found by name:
`configs/<config>.json`, `traffic/<traffic>.json`, `attacks/<attack>.py`
(the traffic's kind of attack), `reference/<reference>.py` (the
configuration's plain network) and one `metrics/<metric>.py` per metric
the cell reports."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: Path = HERE.parent

    def metrics(self, trace: bool) -> list[dict]:
        return self.per_layer if trace else self.end_to_end


def _reports(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load(bench: dict, workload: str, root: Path = HERE.parent) -> Cell:
    """The cell named `workload` of the parsed `BENCHMARK.json`, its files
    read under the checkout `root`."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there "
                       f"are {[w['name'] for w in bench['workloads']]}")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == cell["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / HERE.name / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if _reports(m, workload, {m["name"] for m in bench["end_to_end"]})]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(workload, cell["chips"], config, traffic, e2e, layer, root)


def module(kind: str, name: str, root: Path = HERE.parent):
    """`<kind>/<name>.py` of the benchmark under the checkout `root`,
    imported (a name may hold '.' and '-', so the file is loaded by its
    path)."""
    path = root / HERE.name / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no {kind}/{name}.py")
    key = f"bench_{kind}_{name}"
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_environment(config: dict, root: Path = HERE.parent) -> None:
    """The configuration's `PCFA_*` settings (as a user of the CLI sets
    them) and no other of the program's; the kernel caches of libraries
    under the checkout."""
    import os

    for key in [k for k in os.environ if k.startswith("PCFA_")]:
        del os.environ[key]
    os.environ.update(config["env"])
    cache = root / ".cache" / "pcfa-benchmark"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "cuda"))
