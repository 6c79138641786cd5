"""Shared building blocks of the port's models (``repro.models.layers``):
plain functions on tensors and dict params, in the JAX package's layouts.

The single-card port has no mesh, so ``shard_hint`` and the mesh context
have no counterpart here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

VOCAB_PAD_MULTIPLE = 128  # embedding rows are padded to this multiple


def padded_vocab(vocab: int) -> int:
    return ((vocab + VOCAB_PAD_MULTIPLE - 1) // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype,
               scale: float = 0.02) -> torch.Tensor:
    """Normal(0, scale) drawn in f32 on the generator's device, then cast."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32 with the gemma-style ``(1 + scale)`` gain."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + scale.float())).to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype: torch.dtype) -> Params:
    return {"table": dense_init(gen, (padded_vocab(vocab), d_model), dtype)}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def logits_from_embedding(params: Params, x: torch.Tensor, vocab: int,
                          final_softcap: float = 0.0) -> torch.Tensor:
    """Tied-embedding readout in f32; padded vocab rows read -1e9."""
    table = params["table"]
    logits = (x @ table.t()).float()
    if final_softcap > 0:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    pv = table.shape[0]
    if pv != vocab:
        keep = torch.arange(pv, device=logits.device) < vocab
        logits = torch.where(keep, logits, torch.full_like(logits, -1e9))
    return logits


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Interleaved pairs: (x[2i], x[2i+1]) rotate together, as in the JAX
    package (not the rotate-half convention)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions.float()[..., :, None] * freqs  # (..., seq, hd/2)
    angles = angles[..., :, None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    pairs = x.float().reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    x1, x2 = pairs[..., 0], pairs[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype) -> Params:
    return {
        "wg": dense_init(gen, (d_model, d_ff), dtype),
        "wi": dense_init(gen, (d_model, d_ff), dtype),
        "wo": dense_init(gen, (d_ff, d_model), dtype),
    }


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x wg) * (x wi)) wo``."""
    return (F.silu(x @ params["wg"]) * (x @ params["wi"])) @ params["wo"]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid positions (labels >= 0 unless a mask is given)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).float() if mask is None else mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
