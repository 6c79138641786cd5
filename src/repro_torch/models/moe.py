"""Mixture-of-Experts layer of the port (``repro.models.moe``): top-k
routing with capacity-based one-hot dispatch, step for step as the JAX
package computes it.

Tokens are split, inside each row, into groups of ``gs``; every expert takes
at most ``capacity`` tokens a group, the rest are dropped. Dispatch and
combine are one-hot products over (expert, capacity slot), so every shape is
fixed by (b, s) and the config: no data-dependent shape and no host sync,
and a decode step can be captured in a CUDA graph. On a mesh the JAX
layer's hints apply (``shard_hint``, and :func:`shard_moe` with the model's
``expert_sharding``): the groups, dispatch and combine stay on the batch
axes, and the expert inputs and outputs move to the expert axis (an
all-to-all each way), so each rank runs its own experts; off a mesh they are
the identity.

Top-k breaks ties to the lower expert index, as ``jax.lax.top_k`` does (a
stable descending sort; ``torch.topk`` takes the higher index on the CPU).
At 128 experts with bf16 router logits ties at the k-th place are common,
and which expert wins one moves the capacity cumsum and so the drops.

Besides y and the Switch aux loss, :func:`moe_layer` returns the layer's
per-expert sums (:class:`MoEStats`): the DFL trainer builds the reference's
global-batch aux loss from them (``dfl/trainer.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dfl.sharding import Spec, axis_sizes, placements
from ..kernels import run_local
from .layers import Params, dense_init, gather_tokens, init_mlp, mlp, shard_hint

GROUP_SIZE = 256  # the most tokens in a dispatch group
CAPACITY_TARGET = 6  # the per-group capacity the group size aims at


class MoEStats(NamedTuple):
    """One layer's routing sums over the tokens it saw."""

    f: torch.Tensor  # (e,) f32: tokens that chose each expert in their top k (before drops)
    p: torch.Tensor  # (e,) f32: the router probabilities summed over tokens (differentiable)
    tokens: int  # tokens summed over


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             dtype: torch.dtype, dense_residual_ff: int = 0) -> Params:
    """The router in f32, the experts' SwiGLU weights in the model dtype,
    and arctic's dense residual MLP when ``dense_residual_ff``."""
    p = {
        "router": dense_init(gen, (d_model, n_experts), torch.float32),
        "wg": dense_init(gen, (n_experts, d_model, d_ff), dtype),
        "wi": dense_init(gen, (n_experts, d_model, d_ff), dtype),
        "wo": dense_init(gen, (n_experts, d_ff, d_model), dtype),
    }
    if dense_residual_ff:
        p["dense"] = init_mlp(gen, d_model, dense_residual_ff, dtype)
    return p


def group_size(s: int, n_experts: int, top_k: int, capacity_factor: float) -> Tuple[int, int]:
    """(gs, capacity) for a sequence of s tokens, with the JAX package's
    float-then-int arithmetic: gs aims at a capacity of 6 (at least 16, at
    most 256 and s), then steps down until it divides s."""
    gs = int(CAPACITY_TARGET * n_experts / max(top_k * capacity_factor, 1e-9))
    gs = max(16, min(gs, GROUP_SIZE, s))
    while s % gs:
        gs -= 1
    capacity = max(1, int(gs * top_k * capacity_factor / n_experts))
    return gs, capacity


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot over a new last axis, by comparison (no bounds check, so
    no host sync on the card)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def route(probs: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest probabilities and their experts, ties to the lower
    index (``jax.lax.top_k``'s rule)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :top_k], idx[..., :top_k]


def dispatch_combine(xg: torch.Tensor, router: torch.Tensor, top_k: int, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grouped tokens xg (b, G, gs, d) -> (dispatch, combine (b, G, gs, e, c)
    in xg's dtype, f (e,) the top-k choices before drops, p (e,) the router
    probabilities summed over the tokens). Every group routes on its own: a
    DTensor xg runs each rank's rows (``local_map``), its sums partial over
    the batch's mesh dimensions."""
    if isinstance(xg, DTensor):
        px = tuple(xg.placements)
        if any(not (isinstance(q, Replicate) or q == Shard(0)) for q in px):
            raise ValueError(f"moe routing: groups split on the batch only, got {px}")
        pst = tuple(Partial() if q == Shard(0) else Replicate() for q in px)
        return run_local(dispatch_combine, xg.device_mesh,
                         (px, (Replicate(),) * len(px), None, None), (px, px, pst, pst),
                         xg, router, top_k, capacity)
    b, G, gs, _ = xg.shape
    n_experts = router.shape[1]
    # the router cast to xg's dtype (bf16 logits on the card), then f32
    logits = (xg @ router.to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)  # (b, G, gs, e)

    gate_vals, expert_idx = route(probs, top_k)  # (b, G, gs, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    sel = _one_hot(expert_idx, n_experts)  # (b, G, gs, k, e)
    # slot order: token-major, so a token's first choice comes before its second
    flat_sel = sel.reshape(b, G, gs * top_k, n_experts)
    pos_in_expert = torch.cumsum(flat_sel, dim=2) * flat_sel - 1.0
    pos_in_expert = pos_in_expert.reshape(b, G, gs, top_k, n_experts)
    within_cap = (pos_in_expert >= 0) & (pos_in_expert < capacity)
    cap_oh = _one_hot(pos_in_expert.clamp(0, capacity - 1).long(), capacity)  # (.., e, c)
    keep = (sel * within_cap.float())[..., None]
    dispatch = (keep * cap_oh).sum(dim=3).to(xg.dtype)  # (b, G, gs, e, c)
    combine = (gate_vals[..., None, None] * keep * cap_oh).sum(dim=3).to(xg.dtype)
    return dispatch, combine, sel.sum(dim=(0, 1, 2, 3)), probs.sum(dim=(0, 1, 2))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    DTensor's backward of the reshape ahead of it views the gradient by its
    global strides, which the permuted local gradient does not have
    (PyTorch 2.13 on gloo: "view size is not compatible")."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def shard_moe(t: torch.Tensor, e_dim: int, expert_sharding) -> torch.Tensor:
    """The expert dimension on the expert-parallel axis, the batch on the
    node axes that remain; the identity without ``expert_sharding`` (mesh,
    expert axis, batch axes) or when the experts do not divide the axis."""
    if expert_sharding is None:
        return t
    mesh, e_axis, b_axes = expert_sharding
    sizes = axis_sizes(mesh)
    if t.shape[e_dim] % sizes[e_axis]:
        return t
    rem = tuple(a for a in b_axes if a != e_axis and a in sizes)
    n_b = 1
    for a in rem:
        n_b *= sizes[a]
    if rem and t.shape[0] % n_b:
        rem = ()
    spec = [None] * t.ndim
    spec[0] = rem if rem else None
    spec[e_dim] = e_axis
    want = placements(mesh, Spec(*spec))
    return t if tuple(t.placements) == want else t.redistribute(mesh, want)


def moe_layer(params: Params, x: torch.Tensor, top_k: int, capacity_factor: float = 1.25,
              expert_sharding=None) -> Tuple[torch.Tensor, torch.Tensor, MoEStats]:
    """x (b, s, d) -> (y (b, s, d), the Switch aux loss e sum_e f_e P_e / k,
    the layer's :class:`MoEStats`). ``expert_sharding``: (mesh, expert axis,
    batch axes) on a mesh, for :func:`shard_moe`."""
    b, s, d = x.shape
    n_experts = params["router"].shape[1]
    gs, capacity = group_size(s, n_experts, top_k, capacity_factor)
    G = s // gs
    x = gather_tokens(x)
    xg = shard_hint(x.reshape(b, G, gs, d), "batch", None, None, None)
    dispatch, combine, f, p = dispatch_combine(xg, params["router"], top_k, capacity)
    # dispatch and combine stay on the batch axes; only xe and ye (the
    # expert-parallel all-to-all payloads) move to the expert axis
    dispatch = shard_hint(dispatch, "batch", None, None, None, None)
    combine = shard_hint(combine, "batch", None, None, None, None)

    xe = torch.einsum("bgsd,bgsec->bgecd", xg, dispatch)  # (b, G, e, c, d)
    xe = shard_moe(shard_hint(xe, "batch", None, None, None, None), 2, expert_sharding)
    # every expert's slots as one batch of matmuls: (e, b G c, d)
    xe = xe.permute(2, 0, 1, 3, 4).reshape(n_experts, b * G * capacity, d)
    h = F.silu(torch.bmm(xe, params["wg"])) * torch.bmm(xe, params["wi"])
    ye = torch.bmm(h, params["wo"]).reshape(n_experts, b, G, capacity, d)
    if isinstance(ye, DTensor):
        ye = _ContiguousGrad.apply(ye)
    ye = ye.permute(1, 2, 0, 3, 4)
    ye = shard_hint(shard_moe(ye, 2, expert_sharding), "batch", None, None, None, None)
    y = torch.einsum("bgecd,bgsec->bgsd", ye, combine).reshape(b, s, d)

    if "dense" in params:  # arctic: a dense MLP residual in parallel
        y = y + mlp(params["dense"], x)

    # load-balance aux loss (Switch): f_e the share of top-k choices before
    # drops (no gradient), P_e the mean router probability
    tokens = b * s
    stats = MoEStats(f=f, p=p, tokens=tokens)
    aux = n_experts * torch.sum((stats.f / tokens) * (stats.p / tokens)) / top_k
    return y, aux, stats
