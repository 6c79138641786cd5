"""optimizer_ms (per layer): the gradient's clip and the optimizer's update, from the end of ``DFLTrainer.grads`` to the end of ``trainer.opt.update`` (``optim/optimizers.py``): the mean over the traced window's steps
of the interval between the CUDA events the driver's wrappers record on
the stream around the phase (no sync)."""


def read(ctx):
    phases = ctx["phase_ms"]
    if not phases or not phases["optimizer"]:
        return None
    return sum(phases["optimizer"]) / len(phases["optimizer"])
