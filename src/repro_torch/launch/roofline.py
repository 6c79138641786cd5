"""Roofline terms of one step on one NVIDIA H100 (``repro.launch.roofline``).

Three terms, in seconds, from an :class:`~repro_torch.launch.op_analysis.OpStats`:

  compute    = FLOPs                    / 989e12 op/s (dense bf16)
  memory     = bytes (operands+outputs) / 3.35e12 B/s (HBM3)
  collective = wire bytes               / 450e9 B/s (NVLink 4, one direction)

On one card the stacked nodes' gossip is HBM traffic, already in the
memory term, so :attr:`Roofline.bottleneck` weighs compute against memory;
the collective term is what the plan's bytes would cost between cards. On a
mesh (``n_chips`` > 1, one rank's counts) the wire bytes are the rank's
counted collectives weighted as the JAX roofline weighs HLO collectives
(:data:`WIRE_WEIGHT`: an all-reduce's two phases 2x, the rest 1x), and the
bottleneck weighs all three terms. One link rate prices every axis: a
16-wide "model" axis spans two 8-card NVLink domains, which it does not see.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

# H100 SXM data sheet: dense bf16 tensor-core rate, f32 outside the tensor
# cores, HBM3 rate, NVLink 4 rate in each direction, and memory
PEAK_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BW = 3.35e12
LINK_BW = 450e9
HBM_BYTES = 80e9
WIRE_WEIGHT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}


def wire_bytes(collective_bytes: Dict[str, float]) -> float:
    """A rank's bytes on the wire: each collective kind's bytes by its
    :data:`WIRE_WEIGHT`."""
    return sum(b * WIRE_WEIGHT[kind] for kind, b in collective_bytes.items())


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    peak_memory_per_device: float
    model_flops: float  # 6·N·D (train) / 2·N·D (forward)
    kernel_launches: Dict[str, int] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def bound_s(self) -> float:
        """The least time the step could take: the larger of compute and
        memory, and on a mesh the collective term too."""
        bound = max(self.compute_s, self.memory_s)
        return max(bound, self.collective_s) if self.n_chips > 1 else bound

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s}
        if self.n_chips > 1:
            terms["collective"] = self.collective_s
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.n_chips
        return self.model_flops / total if total else 0.0

    def mfu(self, step_s: float) -> float:
        """Model FLOPs over what the chips' peak does in ``step_s``."""
        return self.model_flops / (step_s * self.n_chips * PEAK_FLOPS)

    def roofline_share(self, step_s: float) -> float:
        """The bound over the step's time: 1 at the roofline."""
        return self.bound_s / step_s

    def as_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "n_chips": self.n_chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound_s": self.bound_s,
            "bottleneck": self.bottleneck,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "peak_memory_gb": self.peak_memory_per_device / 2**30,
            "peak_memory_bytes": self.peak_memory_per_device,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "kernel_launches": dict(self.kernel_launches),
            "collective_counts": dict(self.collective_counts),
        }


def model_flops_for(cfg, shape, kind: str) -> float:
    """6·N·D for training, 2·N·D forward-only (N = active params, D = tokens)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
