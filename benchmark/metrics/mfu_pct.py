"""Model FLOPs of the window's untraced steps (their closures and
forwards, counted on the reference network, `flops.py`) over those steps'
wall time × the H100's dense bf16 peak, in %: the pace of the program
without the profiler, read in a `--trace 1` run, which counts the FLOPs."""

from roofline import PEAK_FLOPS


def read(ctx):
    f = ctx.run.get("flops")
    steps = ctx.window.untraced()
    seconds = sum(s for s, _, _ in steps)
    if f is None or seconds <= 0:
        return None
    work = ctx.pairs * sum(c * f["closure"] + n * f["forward"]
                           for _, c, n in steps)
    return 100.0 * work / (seconds * PEAK_FLOPS["bfloat16"])
