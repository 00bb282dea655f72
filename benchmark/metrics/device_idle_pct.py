"""Share of a step, in %, in which nothing runs on the card: 1 − the
traced slice's device busy time per step (kernels, copies and fills, from
the profiler's device timeline) over the median wall time of the window's
untraced steps, so that the profiler's own host cost, which stretches the
slice, is left out."""

import statistics


def read(ctx):
    tl, w = ctx.run.get("timeline"), ctx.window
    steps = w.untraced()
    if tl is None or not w.slice_steps or not steps:
        return None
    step_s = statistics.median(s for s, _, _ in steps)
    return 100.0 * (1.0 - tl.busy_s() / w.slice_steps / step_s)
