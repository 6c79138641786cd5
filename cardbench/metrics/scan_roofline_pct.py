"""scan_roofline_pct (per layer, ``kernels/scan``): the least time the card
needs for a step's selective scans (forward and backward, every Mamba1
layer of every node, at the cell's shapes) over the profiled device time a
step of the kernels named below.

Frozen copy of the port's ``scan_cost`` / ``scan_bwd_cost``
(``kernels/scan/mamba_scan.py``) for the function's own inputs and outputs:
the forward reads dt (f32), x (the model's dtype), B and C (f32), A_log and
D, and writes y (f32) and the last state, 8 operations a (step, channel,
state) and 2 a (step, channel); the backward reads the forward's inputs and
dy (f32) and writes ddt, dx, dB, dC, dA_log and dD, 18 operations a (step,
channel, state). The chunk states the port's forward saves for its backward
are its own choice and not counted.
"""
import re

import peaks
import profiled

PATTERN = re.compile(r"\b(scan_kernel|scan_bwd_kernel|scan_bwd_finish_kernel)\b")


def step_bound_s(hp, traffic, xs: int = 2) -> float:
    b, s = traffic["rows_per_node"], traffic["seq_len"]
    di, n = hp["intermediate_size"], hp["state_size"]
    fwd = peaks.bound_s(8 * b * s * di * n + 2 * b * s * di,
                        (4 + xs + 4) * b * s * di + 2 * 4 * b * s * n
                        + 4 * (di * n + di + b * di * n))
    bwd = peaks.bound_s(18 * b * s * di * n,
                        (4 + xs + 4 + 4 + xs) * b * s * di + 4 * 4 * b * s * n
                        + 4 * 2 * (di * n + di))
    return (fwd + bwd) * hp["num_hidden_layers"] * traffic["nodes"]


def read(ctx):
    rec, hp = ctx["profile"], ctx["hyper"]
    if rec is None or "state_size" not in hp:
        return None
    t = profiled.kernel_s(rec, PATTERN) / ctx["profiled_steps"]
    return 100.0 * step_bound_s(hp, ctx["traffic"]) / t if t > 0 else None
