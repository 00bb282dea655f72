"""Published attacks completed per second: pairs per attack × steps
completed ÷ steps per attack, over the time from the window's start to the
end of its last step (host clock; the device synchronised at every step)."""


def read(ctx):
    w = ctx.window
    if not w.step_ends:
        return None
    return ctx.pairs * w.steps / ctx.steps_per_attack / (
        w.step_ends[-1] - w.start)
