"""Shared building blocks of the port's models (``repro.models.layers``):
plain functions on tensors and dict params, in the JAX package's layouts.

The mesh context (:func:`set_mesh_ctx`) lets layer internals pin the
placements the JAX package pins with ``with_sharding_constraint``:
:func:`shard_hint` redistributes a DTensor to the placements its dimension
names give. With no mesh set it is the identity, so the one-card path runs
plain tensors exactly as before.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from ..dfl.sharding import Spec, axis_sizes, placements
from ..kernels import run_local

Params = Dict[str, Any]

VOCAB_PAD_MULTIPLE = 128  # embedding rows are padded to this multiple

# -- mesh context ----------------------------------------------------------------------

_MESH_CTX: Dict[str, Any] = {"mesh": None, "batch_axes": ()}


def set_mesh_ctx(mesh: Any, batch_axes: Tuple[str, ...] = ()) -> None:
    _MESH_CTX["mesh"] = mesh
    _MESH_CTX["batch_axes"] = tuple(batch_axes)


def get_mesh_ctx() -> Tuple[Any, Tuple[str, ...]]:
    return _MESH_CTX["mesh"], _MESH_CTX["batch_axes"]


def mesh_scope():
    """The context a meshed forward runs in: plain tensors the model makes
    (positions, masks) count as replicated beside DTensors. A null context
    with no mesh."""
    return implicit_replication() if _MESH_CTX["mesh"] is not None else contextlib.nullcontext()


def shard_hint(t: torch.Tensor, *dims: Optional[str]) -> torch.Tensor:
    """``with_sharding_constraint`` by per-dimension axis names: a mesh
    axis name, "batch" (the configured batch axes) or None. Every entry is
    checked for divisibility and dropped when invalid; the identity with no
    mesh or when every entry drops, else ``t`` redistributed to the
    placements of the hint (a plain tensor is taken as replicated first)."""
    mesh, ba = _MESH_CTX["mesh"], _MESH_CTX["batch_axes"]
    if mesh is None:
        return t
    sizes = axis_sizes(mesh)
    entries = []
    for size, ax in zip(t.shape, dims):
        if ax == "batch":
            n = 1
            for a in ba:
                n *= sizes.get(a, 1)
            ax = ba if (ba and n > 1 and size % n == 0) else None
        elif ax is not None and (ax not in sizes or sizes[ax] == 1 or size % sizes[ax]):
            ax = None
        entries.append(ax)
    if all(e is None for e in entries):
        return t
    spec = Spec(*entries)
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    want = placements(mesh, spec)
    return t if tuple(t.placements) == want else t.redistribute(mesh, want)


def reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """A DTensor with its partial sums reduced (all-reduced to replicas);
    anything else as it is."""
    if not isinstance(t, DTensor) or not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


def gather_tokens(x: torch.Tensor) -> torch.Tensor:
    """A DTensor (b, ...) split on its batch alone: every other split (the
    sequence of sequence parallelism) gathered and partial sums reduced, once
    ahead of the projections that share it (DTensor redistributes an operand
    for each op that reads it, and does not reuse a gather across ops as XLA
    does). Anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def padded_vocab(vocab: int) -> int:
    return ((vocab + VOCAB_PAD_MULTIPLE - 1) // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype,
               scale: float = 0.02) -> torch.Tensor:
    """Normal(0, scale) drawn in f32 on the generator's device, then cast."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32 with the gemma-style ``(1 + scale)`` gain. A DTensor
    x runs on each rank's rows (``local_map``): the norm reads one row."""
    if isinstance(x, DTensor):
        x = reduce_partial(x)
        if Shard(x.ndim - 1) in x.placements:
            x = gather_tokens(x)
        r = Replicate()
        return run_local(rms_norm, x.device_mesh, (x.placements, (r,) * x.device_mesh.ndim,
                                                     None), (x.placements,), x, scale, eps)
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + scale.float())).to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype: torch.dtype) -> Params:
    return {"table": dense_init(gen, (padded_vocab(vocab), d_model), dtype)}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    table = params["table"]
    if isinstance(table, DTensor):  # a vocab-split table: masked lookups, then all-reduced
        return reduce_partial(F.embedding(tokens, table))
    return table[tokens]


def logits_from_embedding(params: Params, x: torch.Tensor, vocab: int,
                          final_softcap: float = 0.0) -> torch.Tensor:
    """Tied-embedding readout in f32; padded vocab rows read -1e9."""
    table = params["table"]
    logits = (gather_tokens(x) @ table.t()).float()
    if final_softcap > 0:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    pv = table.shape[0]
    if pv != vocab:
        keep = torch.arange(pv, device=logits.device) < vocab
        if isinstance(logits, DTensor):  # (a plain mask has no gradient placement)
            keep = DTensor.from_local(keep, logits.device_mesh,
                                      [Replicate()] * logits.device_mesh.ndim, run_check=False)
        logits = torch.where(keep, logits, torch.full_like(logits, -1e9))
    return logits


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Interleaved pairs: (x[2i], x[2i+1]) rotate together, as in the JAX
    package (not the rotate-half convention). A DTensor x split on its batch,
    sequence or heads runs on each rank's shard (``local_map``), the
    positions split alike."""
    if isinstance(x, DTensor):
        px = tuple(x.placements)
        if any(not (isinstance(p, Replicate) or p in (Shard(0), Shard(1), Shard(2)))
               for p in px):
            raise ValueError(f"apply_rope: x split on batch, sequence or heads only, got {px}")
        pp = tuple(p if p in (Shard(0), Shard(1)) else Replicate() for p in px)
        return run_local(apply_rope, x.device_mesh, (px, pp, None), (px,), x, positions, theta)
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
    x = gather_tokens(x)
    return (F.silu(x @ params["wg"]) * (x @ params["wi"])) @ params["wo"]


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid positions (labels >= 0 unless a mask is given)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).float() if mask is None else mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
