"""Graph-time every candidate plan of the patch-correlation kernels.

For PWCNet's five correlation levels (384×1280, B = 1, patch 9) and
FlowNetC's shape (patch 21, stride 2), bf16 and float32, forward and
backward, every plan that `pcfa_tpu_torch/ops/local_corr._candidates`
offers is launched with 256 and with 512 threads (float32's forward: 256),
checked against the plain version (the tolerances of `chip_smoke.py`'s
phase 2) and timed by CUDA-graph replay (`chip_smoke.graph_ms`). These
timings are the data behind `_candidates`' cost weights.

    python3 sweep_local_corr.py [TIMINGS.jsonl]

needs one CUDA card. It prints, for each dtype, kind and shape, the
planned plan's time, the best candidate's time and plan, and the planned
plan's place among all candidates, and writes every timing with its plan
to TIMINGS.jsonl where one is named. It exits non-zero if a candidate is
refused by the kernel or disagrees with the plain version.
"""

from __future__ import annotations

import contextlib
import json
import sys

import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_local_corr: needs a CUDA card", file=sys.stderr)
        return 1
    from pcfa_tpu_torch._device import resolve_device
    from pcfa_tpu_torch.ops import _build, local_corr as lc

    resolve_device("cuda")
    print(f"# card: {cs.card_line()}", flush=True)
    _build.build(["local_corr"])  # a failed build stops here
    shapes = [(n, h, w, c, 9, 1) for n, h, w, c in cs.PWC_LEVELS] + [
        ("FlowNetC", 48, 160, 256, 21, 2)]
    gen = torch.Generator().manual_seed(0)
    bad = 0
    with (open(sys.argv[1], "w") if len(sys.argv) > 1
          else contextlib.nullcontext()) as log:
        for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
            esz = torch.empty((), dtype=dtype).element_size()
            for tag, h, w, c, patch, s in shapes:
                f1, f2 = (torch.randn((1, h, w, c), generator=gen)
                          .to("cuda", dtype) for _ in range(2))
                g = torch.randn((1, h, w, patch * patch),
                                generator=gen).to("cuda", dtype)
                refs = {"fwd": [lc.local_corr_plain(f1, f2, patch, s)],
                        "bwd": lc.local_corr_bwd_plain(g, f1, f2, patch, s)}
                for kind in ("fwd", "bwd"):
                    key = (kind, (1, h, w, c), patch, s, esz)
                    planned = lc._plan(kind, 1, h, w, c, patch, s, esz)
                    ranked = sorted(lc._candidates(kind, 1, h, w, c, patch,
                                                   s, esz),
                                    key=lambda kp: kp[0])
                    run = ((lambda: [lc.local_corr_fwd(f1, f2, patch, s)])
                           if kind == "fwd" else
                           (lambda: lc.local_corr_bwd(g, f1, f2, patch, s)))
                    times = []
                    # float32's forward runs 256 threads at most
                    choices = ((256,) if (kind, esz) == ("fwd", 4)
                               else (256, 512))
                    for i, (_, plan) in enumerate(ranked):
                        for threads in choices:
                            pl = plan._replace(threads=threads)
                            ints = [getattr(pl, f) for f in lc.PLAN_FIELDS]
                            lc._plans[key] = (pl, (lc._I * len(ints))(*ints))
                            rec = {"dtype": str(dtype)[6:], "kind": kind,
                                   "shape": tag, "rank": i,
                                   "planned": pl == planned,
                                   "plan": pl._asdict()}
                            try:
                                got = run()
                                for a, b in zip(got, refs[kind]):
                                    cs.check_close(f"{tag} {kind}", a, b, tol)
                                rec["ms"] = cs.graph_ms(run, reps=10)
                            except (AssertionError, RuntimeError) as e:
                                rec["error"] = str(e)[:300]
                                bad += 1
                                print(f"FAILED {rec}", flush=True)
                            times.append(rec)
                            if log is not None:
                                log.write(json.dumps(rec) + "\n")
                    lc._plans.clear()
                    ok = [r for r in times if "ms" in r]
                    best = min(ok, key=lambda r: r["ms"])
                    mine = next(r for r in ok if r["planned"])
                    place = sorted(r["ms"] for r in ok).index(mine["ms"])
                    fields = {k: best["plan"][k] for k in (
                        "th", "mf", "pb", "kc", "nchunk", "ksplit",
                        "cgroups", "nbuf", "threads", "gmode", "ngroup",
                        "blocks")}
                    print(f"{str(dtype)[6:]} {kind} {tag}: planned "
                          f"{mine['ms']:.4f} ms (place {place} of "
                          f"{len(ok)}), best {best['ms']:.4f} ms (model "
                          f"rank {best['rank']}) {fields}", flush=True)
                del f1, f2, g, refs
    print(json.dumps({"failed": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
