#!/usr/bin/env python3
"""The correctness control: the reference put in the program's place and
run one precision step below what the configuration states, part by part
(`config['control']`: the bf16 network in fp8, operands of every product
rounded to e4m3 and gradients to e5m2 with per-tensor scales; the L-BFGS
products and history one step below the history's dtype; the engine's
float32 norms in bf16), judged by the same comparison as a run, on the
cell's own first attack at its own size.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

One JSON line per seed with the numbers `check.judge` gives; then their
least and most per number (the control's least is the reading a limit
must stay below). With `--program`, the same numbers of the program's own
timed path instead (`harness.run` with a window of one step, per seed, in
one process): the sound runs' readings. Runs on the card (or `--device
cpu`, for the tests at a small size). The benchmark's own runs do not run
it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent


def readings(cell, seed: int, device) -> dict:
    """The numbers of one seed: the control (`config['control']`) in the
    program's place, judged against the float32 reference."""
    import torch

    import cells
    import check
    import synthetic
    import weights
    from reference import common

    cfg, traffic = cell.config, cell.traffic
    ref_module = cells.module("reference", cfg["reference"], cell.root)
    with torch.device("meta"):
        published = getattr(ref_module, cfg["reference_class"])(
            **cfg["model"])
    path = os.path.join(tempfile.gettempdir(), "pcfa-benchmark",
                        f"control-{cfg['name']}.pth")
    weights.save(weights.make(published, seed, device, **cfg["weights"]),
                 path, cfg["checkpoint_container"])
    common.plain_float32()
    pairs = traffic["pairs"]
    judged = check.sample_pairs(seed, pairs, traffic["checked_pairs"])
    images = synthetic.batch(seed, 0, pairs, tuple(cfg["image_hw"]),
                             traffic["max_shift"])
    low = cfg["control"]
    net = check.reference_net(cfg, ref_module, path, device, low["network"])
    got = check.low_precision_answers(cfg, traffic, net, *images, judged,
                                      device)
    del net
    net = check.reference_net(cfg, ref_module, path, device)
    numbers = check.judge(cfg, traffic, net, *images, got, device)
    os.remove(path)
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--program", action="store_true",
                   help="read the program's numbers instead: one window of "
                        "one step per seed, in this process")
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import torch

    import cells

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = cells.load(bench, args.workload)
    device = torch.device(args.device)
    rows = []
    if args.program:
        import time

        import harness

        cells.set_environment(cell.config)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            out = harness.run(cell, seed, 0.0, False, device,
                              time.perf_counter())
            rows.append({k: v["value"] for k, v in out["checks"].items()})
            what = {"program": cell.config["env"], "failed": out["failed"]}
        else:
            rows.append(readings(cell, seed, device))
            what = {"control": cell.config["control"]}
        print(json.dumps({"workload": args.workload, "seed": seed, **what,
                          **rows[-1]}), flush=True)
    print(json.dumps({"workload": args.workload,
                      "least": {k: min(r[k] for r in rows) for k in rows[0]},
                      "most": {k: max(r[k] for r in rows) for k in rows[0]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
