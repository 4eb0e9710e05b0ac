"""`torch.cuda.max_memory_allocated()` from the start of the served
path's warm-up to the end of the window, in MiB (weights included)."""


def read(ctx):
    return ctx.peak_bytes / 2**20 if ctx.peak_bytes else None
