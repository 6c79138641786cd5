"""Public flash-attention op: the Hopper kernels on CUDA, the plain versions
on the CPU.

A call that autograd will differentiate (grad mode on and q, k or v
requiring a gradient) goes through :class:`FlashAttention`: its forward
keeps the rows' log-sum-exp beside the output, and its backward is the
backward kernel on the card (``flash_attention_bwd``) and
``attention_bwd_ref`` on the CPU. Any other call launches the forward
alone, as inference always did. A fake tensor takes the kernels' fake
route; each call is one :class:`~repro_torch.kernels.kernel_call`.

DTensors (a meshed model) go through :func:`_flash_local`: q, k and v split
on their batch and head dimensions only, and each rank runs the op on its
local heads. Where the query heads are split over a mesh dimension that
leaves the kv heads whole (GQA with fewer kv heads than ranks: qwen3-moe's
4 over 16), a rank takes the kv heads of its own query heads' groups, a
slice when they are contiguous and evenly shared, else one gathered kv head
a query head, as the JAX package's expansion would hold them.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import kernel_call, on_card, run_local
from .flash import flash_attention, flash_attention_bwd, flash_bwd_cost, flash_cost
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref


class FlashAttention(torch.autograd.Function):
    """Attention with the kernels' forward and backward (the plain versions
    on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sliding_window: int, softcap: float):
        kw = dict(causal=causal, sliding_window=sliding_window, softcap=softcap)
        with kernel_call("flash_attention", flash_cost, q, k, causal, sliding_window, True):
            if on_card(q, "flash_attention"):
                out, lse = flash_attention(q, k, v, return_lse=True, **kw)
            else:
                out, lse = attention_lse_ref(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.to(out.dtype)
        kw = ctx.kw
        with kernel_call("flash_attention_bwd", flash_bwd_cost, q, k, kw["causal"],
                         kw["sliding_window"]):
            bwd = flash_attention_bwd if on_card(q, "flash_attention") else attention_bwd_ref
            dq, dk, dv = bwd(q, k, v, out, lse, do, **kw)
        return dq, dk, dv, None, None, None


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, sliding_window: int = 0,
                       softcap: float = 0.0) -> torch.Tensor:
    """Attention over q (b, s_q, H, hd) and k, v (b, s_kv, KV, hd):
    (b, s_q, H, hd) in q's dtype."""
    kw = dict(causal=causal, sliding_window=sliding_window, softcap=softcap)
    if isinstance(q, DTensor):
        return _flash_local(q, k, v, kw)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, sliding_window, softcap)
    with kernel_call("flash_attention", flash_cost, q, k, causal, sliding_window, False):
        if on_card(q, "flash_attention"):
            return flash_attention(q, k, v, **kw)
        return attention_ref(q, k, v, **kw)


def kv_heads_of(first: int, n_local: int, group: int) -> Tuple[int, ...]:
    """The kv head each of the query heads ``first .. first + n_local - 1``
    reads (query head h reads kv head h // group)."""
    return tuple((first + j) // group for j in range(n_local))


def select_kv_heads(k: torch.Tensor, v: torch.Tensor, mesh, head_dims: List[int],
                    n_local: int, group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole kv heads (b, s, KV, hd) -> the kv heads of this rank's
    ``n_local`` query heads, whose split over the mesh dimensions
    ``head_dims`` gives the rank's block: a slice when each of them serves
    the same number of the rank's query heads, else one kv head a query
    head."""
    c = 0
    for i in head_dims:
        c = c * mesh.size(i) + mesh.get_local_rank(i)
    heads = kv_heads_of(c * n_local, n_local, group)
    lo, span = heads[0], heads[-1] + 1 - heads[0]
    if n_local % span == 0 and heads == kv_heads_of(lo * (n_local // span), n_local,
                                                    n_local // span):
        return k[:, :, lo:lo + span], v[:, :, lo:lo + span]
    idx = torch.tensor(heads, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _flash_local(q: DTensor, k: DTensor, v: DTensor, kw) -> DTensor:
    """The flash op on each rank's local heads (``local_map``); the output
    is placed as q."""
    mesh = q.device_mesh
    pq, pk = tuple(q.placements), tuple(k.placements)
    for p in pq + pk:
        if not (isinstance(p, Replicate) or p in (Shard(0), Shard(2))):
            raise ValueError(f"flash_attention: q, k and v split on batch or heads only, got "
                             f"{pq} and {pk}")
    head_dims: List[int] = [i for i, p in enumerate(pq) if p == Shard(2)]
    select = any(pk[i] != Shard(2) for i in head_dims)
    group = q.shape[2] // k.shape[2]

    def local(ql: torch.Tensor, kl: torch.Tensor, vl: torch.Tensor) -> torch.Tensor:
        if select:
            kl, vl = select_kv_heads(kl, vl, mesh, head_dims, ql.shape[2], group)
        return flash_attention_op(ql, kl, vl, **kw)

    return run_local(local, mesh, (pq, pk, pk), (pq,), q, k, v)
