"""Hopper FedAvg mix kernel (``csrc/gossip_mix.cu``).

Replaces ``repro.kernels.mixing.gossip_mix.gossip_mix`` (Pallas): the
weighted sum over the N model copies of a ``(batch, N, P)`` buffer, one
launch for every node of the batch axis. Bound by bytes; the source file
states the bound and the design. CUDA tensors only: :mod:`.ops` dispatches;
a fake tensor takes the fake route (the output, no launch).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import Cost, count_launch, is_fake
from .._build import check, lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mix_cost(buffer: torch.Tensor) -> Optional[Cost]:
    """One launch: the (batch, n, p) buffer read and (batch, p) written
    once; a multiply and an add an element read."""
    batch, n, p = buffer.shape
    if not batch * p:
        return None
    return Cost(2 * buffer.numel(), (buffer.numel() + batch * p) * buffer.element_size())


def gossip_mix(buffer: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(batch, n, p) f32/bf16 and (n,) weights -> (batch, p) in buffer dtype."""
    if (buffer.device.type != "cuda" and not is_fake(buffer)) or weights.device != buffer.device:
        raise ValueError("gossip_mix: expected buffer and weights on one CUDA device")
    if buffer.dtype not in _DTYPES:
        raise ValueError(f"gossip_mix: buffer dtype {buffer.dtype} not in {list(_DTYPES)}")
    if buffer.dim() != 3 or not buffer.is_contiguous():
        raise ValueError("gossip_mix: expected a contiguous (batch, n, p) buffer")
    batch, n, p = buffer.shape
    if batch > 65535:
        raise ValueError(f"gossip_mix: batch {batch} exceeds the kernel's 65535")
    w = weights.to(torch.float32).contiguous()
    if w.shape != (n,):
        raise ValueError(f"gossip_mix: weights {tuple(w.shape)} do not match n={n}")
    out = torch.empty((batch, p), dtype=buffer.dtype, device=buffer.device)
    if out.numel() and not is_fake(buffer):
        with torch.cuda.device(buffer.device):
            status = lib().rt_gossip_mix(
                buffer.data_ptr(), w.data_ptr(), out.data_ptr(), batch, n, p,
                _DTYPES[buffer.dtype],
                torch.cuda.current_stream(buffer.device).cuda_stream)
        count_launch("gossip_mix", (batch, n, p))
        check(status, "gossip_mix")
    return out
