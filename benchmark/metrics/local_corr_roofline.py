"""The patch correlation's share of its roofline, in %: Σ least time of
the slice's forward and backward launches (`kernels/local_corr.py`, at
the configuration's shapes, times the program's launch counters) over
their Σ device time in the trace; nothing where the trace holds fewer of
its launches than the counters counted."""

from kernels import local_corr


def read(ctx):
    tl = ctx.run.get("timeline")
    if tl is None:
        return None
    launches = ctx.window.launches.get("local_corr", {})
    if tl.count(lambda o: local_corr.matches(o.name)) != \
            sum(launches.values()):
        return None
    t = tl.time_s(lambda o: local_corr.matches(o.name))
    bound = local_corr.bound_total_s(ctx.config, ctx.pairs, launches)
    if not t or bound is None:
        return None
    return 100.0 * bound / t
