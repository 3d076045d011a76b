"""Peak device memory of the traced window in GB (1e9 bytes):
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the window's start."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
