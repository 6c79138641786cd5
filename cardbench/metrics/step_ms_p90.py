"""step_ms_p90 (end to end): the 90th percentile (nearest rank) of the
window's step times, each the interval between the CUDA events recorded on
the stream at consecutive ``train_step`` boundaries (the device's clock, no
sync). The p90 is the highest percentile with ten steps beyond it in the
longest cell's window."""
import math


def read(ctx):
    ms = sorted(ctx["step_ms"])
    return ms[math.ceil(0.9 * len(ms)) - 1] if ms else None
