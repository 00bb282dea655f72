"""The warp backward's share of its roofline, in %: Σ least time of the
slice's launches (`kernels/warp_bwd.py`, at the configuration's shapes,
times the program's launch counter) over their Σ device time in the
trace; nothing where the trace holds fewer of its launches than the
counter counted."""

from kernels import warp_bwd


def read(ctx):
    tl = ctx.run.get("timeline")
    if tl is None:
        return None
    launches = ctx.window.launches.get("warp_bwd", {})
    if tl.count(lambda o: warp_bwd.matches(o.name)) != \
            sum(launches.values()):
        return None
    t = tl.time_s(lambda o: warp_bwd.matches(o.name))
    bound = warp_bwd.bound_total_s(ctx.config, ctx.pairs, launches)
    if not t or bound is None:
        return None
    return 100.0 * bound / t
