"""`pairs_per_s` in the cells where the card sets the pace, held under a
bound of its own: there the host's noise, which puts `pairs_per_s`'s bound
at its cap, does not reach the rate."""

import cells


def read(ctx):
    return cells.module("metrics", "pairs_per_s", ctx.cell.root).read(ctx)
