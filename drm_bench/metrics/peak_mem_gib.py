"""torch.cuda.max_memory_allocated() over the window (reset at its start):
the resident index and the served path's workspace."""


def read(ctx):
    return ctx.peak_mem_bytes / 2**30 if ctx.peak_mem_bytes is not None else None
