"""train_tokens_per_s (end to end): every node's tokens of every step the
window completed, over the window's wall time (host clock, the device
synchronised at the window's start and end, nothing read back inside)."""


def read(ctx):
    return ctx["steps"] * ctx["tokens_per_step"] / ctx["window_s"]
