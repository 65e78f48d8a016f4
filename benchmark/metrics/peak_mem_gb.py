"""peak_mem_gb: the window's peak of the CUDA caching allocator on the
fullest card (torch.cuda.max_memory_allocated, reset after set-up), in
GB (1e9 bytes); nothing where no card ran."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9 if ctx["peak_bytes"] else None
