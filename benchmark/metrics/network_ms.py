"""Device time per closure of the network: what is launched under
`bench.flow_fn` in the closures, and autograd's backward (on its own
thread; the loss's few operations ride along), over the slice's
closures."""


def read(ctx):
    tl, w = ctx.run.get("timeline"), ctx.window
    if tl is None or not w.slice_closures:
        return None
    t = tl.time_s(lambda o: o.layer in ("network", "backward"))
    return 1e3 * t / w.slice_closures if t > 0 else None
