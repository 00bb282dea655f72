"""Device launches (kernels, copies, fills) in the slice, over its
closures: what the host dispatches for one forward and backward and its
share of the step around it."""


def read(ctx):
    tl, w = ctx.run.get("timeline"), ctx.window
    if tl is None or not w.slice_closures:
        return None
    return tl.count() / w.slice_closures
