"""Public gossip-mix op: the Hopper kernel on CUDA, the plain version on CPU."""
from __future__ import annotations

import torch

from .gossip_mix import gossip_mix
from .ref import gossip_mix_ref


def gossip_mix_op(buffer: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum over axis 1 of a ``(batch, n, p)`` buffer: ``(batch, p)``."""
    if buffer.device.type == "cuda":
        return gossip_mix(buffer.contiguous(), weights)
    if buffer.device.type == "cpu":
        return gossip_mix_ref(buffer, weights)
    raise ValueError(f"gossip_mix runs on CUDA or CPU tensors, got {buffer.device}")


def fedavg_mean(buffer: torch.Tensor) -> torch.Tensor:
    """FedAvg over axis 1 of ``(batch, n, p)``: the mix with weights 1/n
    (the port's stand-in for the JAX package's ``jnp.mean``)."""
    n = buffer.shape[1]
    w = torch.full((n,), 1.0 / n, dtype=torch.float32, device=buffer.device)
    return gossip_mix_op(buffer, w)
