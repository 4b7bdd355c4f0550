"""The allocator's peak device memory over set-up and window
(``torch.cuda.max_memory_allocated``, the process's own), in GiB."""


def read(ctx):
    return ctx.memory_peak_bytes / 2 ** 30 if ctx.memory_peak_bytes else None
