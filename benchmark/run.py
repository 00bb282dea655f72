#!/usr/bin/env python3
"""Run one cell of `BENCHMARK.json` once, on the card, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. It drives `pcfa_tpu_torch` only. The last
line of standard output is the result, one JSON object: `correct`,
`attempted` and `failed` (steps of the window), `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer ones), `device`,
with `--trace 1` a `breakdown`, and last `checks`, each number compared
with its limit (also the last lines of standard error). Lines before it
give the step times, the traced slice's own rate and the set-up. Exits
with 3, and prints no result, without as many cards as the cell asks for;
with 4 if a JAX module was loaded; with 1 on any other failure.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """`time.perf_counter()`'s reading at this process's start (Linux:
    the start time in /proc, against the boot-time clock)."""
    try:
        with open(f"/proc/{os.getpid()}/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf(
            "SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_PROCESS = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pcfa_tpu"}


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def breakdown(tl) -> dict:
    by_name: dict[str, float] = {}
    for o in tl.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n[:160], s] for s, n in tl.gaps]}


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch

    import cells
    import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cells.load(bench, args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has {cards}", file=sys.stderr)
        return 3
    cells.set_environment(cell.config)
    try:
        import pcfa_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program under test is missing ({e})",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      device, T_PROCESS)

    found = loaded_forbidden()
    if found:
        print(f"benchmark: the run loaded {found}; nothing of JAX or the JAX "
              f"package may run here", file=sys.stderr)
        return 4
    card = power_limit()
    w = out["window"]
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "card": card, "setup_s": out["setup_s"],
                      "attacks_started": w.attacks,
                      "step_times": harness.step_summary(w)}))
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips,
                   "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device_info}
    if args.trace:
        tl = out["timeline"]
        device_info.update(busy_s=tl.busy_s(), window_s=tl.window_s)
        result["breakdown"] = breakdown(tl)
        layers: dict[str, float] = {}
        for o in tl.ops:
            layers[o.layer] = (layers.get(o.layer, 0.0)
                               + (o.end - o.start) * 1e-9)
        print(json.dumps({
            "slice_pairs_per_s": out["pairs"] * w.slice_steps
            / out["steps_per_attack"] / w.slice_s,
            "slice_s": w.slice_s, "slice_closures": w.slice_closures,
            "slice_forwards": w.slice_forwards, "launches": w.launches,
            "device_s_by_layer": layers, "device_events": tl.kinds,
            "flops_per_pair": out["flops"],
            "card": card}))
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
