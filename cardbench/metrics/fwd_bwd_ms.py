"""fwd_bwd_ms (per layer): the nodes' forward and backward, ``DFLTrainer.grads`` (the models and their kernels): the mean over the traced window's steps
of the interval between the CUDA events the driver's wrappers record on
the stream around the phase (no sync)."""


def read(ctx):
    phases = ctx["phase_ms"]
    if not phases or not phases["fwd_bwd"]:
        return None
    return sum(phases["fwd_bwd"]) / len(phases["fwd_bwd"])
