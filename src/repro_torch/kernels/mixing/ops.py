"""Public gossip-mix op: the Hopper kernel on CUDA, the plain version on CPU
(a fake tensor: the kernel's fake route), one
:class:`~repro_torch.kernels.kernel_call` a call."""
from __future__ import annotations

import torch

from .. import kernel_call, on_card
from .gossip_mix import gossip_mix, mix_cost
from .ref import gossip_mix_ref


def gossip_mix_op(buffer: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum over axis 1 of a ``(batch, n, p)`` buffer: ``(batch, p)``."""
    with kernel_call("gossip_mix", mix_cost, buffer):
        if on_card(buffer, "gossip_mix"):
            return gossip_mix(buffer.contiguous(), weights)
        return gossip_mix_ref(buffer, weights)


def fedavg_mean(buffer: torch.Tensor) -> torch.Tensor:
    """FedAvg over axis 1 of ``(batch, n, p)``: the mix with weights 1/n
    (the port's stand-in for the JAX package's ``jnp.mean``)."""
    n = buffer.shape[1]
    w = torch.full((n,), 1.0 / n, dtype=torch.float32, device=buffer.device)
    return gossip_mix_op(buffer, w)
