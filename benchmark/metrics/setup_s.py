"""Seconds from the process's start to the window's start: imports, the
kernels' build (first run of a checkout only), the weights, the model's
load and the warm-up."""


def read(ctx):
    return ctx.setup_s
