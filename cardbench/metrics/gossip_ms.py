"""gossip_ms (per layer): the MOSGU round, ``DFLTrainer.gossip`` (``dfl/collectives.py::gossip_exchange``): the mean over the traced window's steps
of the interval between the CUDA events the driver's wrappers record on
the stream around the phase (no sync)."""


def read(ctx):
    phases = ctx["phase_ms"]
    if not phases or not phases["gossip"]:
        return None
    return sum(phases["gossip"]) / len(phases["gossip"])
