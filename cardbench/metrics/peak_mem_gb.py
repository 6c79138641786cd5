"""peak_mem_gb (end to end): ``torch.cuda.max_memory_allocated()`` over the
set-up and the window, in GB (1e9 bytes): whether the N nodes fit one card."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9
