"""Peak device memory over the window (`torch.cuda.max_memory_allocated`,
reset at the window's start), in GiB."""


def read(ctx):
    return ctx.memory_peak_bytes / 2 ** 30 if ctx.memory_peak_bytes else None
