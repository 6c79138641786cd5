"""setup_s (end to end): from the start of the process's script to the
first timed step: imports, the kernel library's build or load, the model,
the weights, the data pool, the checked steps and the warm-up steps."""


def read(ctx):
    return ctx["setup_s"]
