"""Device time per L-BFGS iteration of the optimizer and the engine's
bookkeeping: every device operation launched under `bench.outer_step`
outside the flow function and its backward, over the slice's iterations
(one closure each)."""


def read(ctx):
    tl, w = ctx.run.get("timeline"), ctx.window
    if tl is None or not w.slice_closures:
        return None
    t = tl.time_s(lambda o: o.layer == "step")
    return 1e3 * t / w.slice_closures if t > 0 else None
