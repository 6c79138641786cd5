"""mix_roofline_pct (per layer, ``kernels/mixing``): the least time the card
needs for a dissemination round's FedAvg mix (each of the N nodes reads the
N f32 copies of the P-element model it holds and writes their weighted
sum) over the profiled device time a step of the mix kernel.

Frozen copy of the port's ``mix_cost`` (``kernels/mixing/gossip_mix.py``):
the (N, N, P) buffer read and (N, P) written once, a multiply and an add an
element read.
"""
import re

import peaks
import profiled

PATTERN = re.compile(r"\bmix_kernel\b")


def step_bound_s(leaf_sizes, nodes: int) -> float:
    p = sum(leaf_sizes)
    return peaks.bound_s(2 * nodes * nodes * p, 4 * (nodes * nodes * p + nodes * p))


def read(ctx):
    rec, t = ctx["profile"], ctx["traffic"]
    if rec is None or t["gossip_mode"] != "dissemination":
        return None
    sec = profiled.kernel_s(rec, PATTERN) / ctx["profiled_steps"]
    return 100.0 * step_bound_s(ctx["leaf_sizes"], t["nodes"]) / sec if sec > 0 else None
