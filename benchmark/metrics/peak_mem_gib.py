"""The device memory the window's program held at its peak
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
