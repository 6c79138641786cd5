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
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from ..dfl.sharding import Spec, axis_sizes, placements
from ..kernels import run_local

Params = Dict[str, Any]

VOCAB_PAD_MULTIPLE = 128  # embedding rows are padded to this multiple

# a gather and a reduce-scatter along a given dimension: the ``*_single``
# names in newer torch, which deprecates the ``*_tensor`` ones
_all_gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
_reduce_scatter = getattr(funcol, "reduce_scatter_single", None) or funcol.reduce_scatter_tensor

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


def _model_dim(t: DTensor) -> Optional[int]:
    names = t.device_mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def _contiguous_stride(shape: torch.Size) -> Tuple[int, ...]:
    stride, n = [], 1
    for size in reversed(shape):
        stride.append(n)
        n *= size
    return tuple(reversed(stride))


def _from_local(local: torch.Tensor, like: DTensor, placements) -> DTensor:
    return DTensor.from_local(local, like.device_mesh, placements, run_check=False,
                              shape=like.shape, stride=_contiguous_stride(like.shape))


def _seq_split(t: DTensor, i: int) -> bool:
    """Whether (b, s, ...) can be split over mesh dimension ``i`` along s,
    evenly, every other dimension split along b at most."""
    n = t.device_mesh.size(i)
    return (t.ndim >= 3 and n > 1 and t.shape[1] % n == 0
            and all(j == i or p == Shard(0) or isinstance(p, Replicate)
                    for j, p in enumerate(t.placements)))


class _SeqGather(torch.autograd.Function):
    """Megatron's sequence-parallel gather on local shards: (b, s, ...) split
    over mesh dimension ``i`` along s, all-gathered to the whole sequence.
    The backward reduce-scatters the gradient, a partial sum over the
    column-parallel projections that read the gathered tensor (a replicated
    gradient is sliced). DTensor's own redistribution would leave the
    gradient split along s into a matmul that flattens it to rows, a
    strided shard its backward ``mm`` cannot place."""

    @staticmethod
    def forward(ctx, x: DTensor, i: int) -> DTensor:
        ctx.x, ctx.i = (tuple(x.placements), x.device_mesh), i
        out = funcol.wait_tensor(_all_gather(x.to_local().contiguous(), 1, (x.device_mesh, i)))
        want = list(x.placements)
        want[i] = Replicate()
        return _from_local(out, x, want)

    @staticmethod
    def backward(ctx, g: DTensor):
        (pin, mesh), i = ctx.x, ctx.i
        want = list(pin)
        want[i] = g.placements[i]
        if tuple(g.placements) != tuple(want):
            g = g.redistribute(mesh, want)
        local, p = g.to_local().contiguous(), g.placements[i]
        if p.is_partial():
            local = funcol.wait_tensor(_reduce_scatter(local, p.reduce_op, 1, (mesh, i)))
        elif isinstance(p, Replicate):
            local = local.chunk(mesh.size(i), dim=1)[mesh.get_local_rank(i)].contiguous()
        return _from_local(local, g, pin), None


class _SeqScatter(torch.autograd.Function):
    """Megatron's sequence-parallel reduce-scatter on local shards: a
    row-parallel output (b, s, ...), a partial sum over mesh dimension
    ``i``, reduced and split along s (a replicated one is sliced). The
    backward all-gathers the gradient to the whole sequence (the gradient
    of a partial sum or of a replica is replicated)."""

    @staticmethod
    def forward(ctx, y: DTensor, i: int) -> DTensor:
        mesh = y.device_mesh
        ctx.y, ctx.i = (tuple(y.placements), mesh), i
        p, local = y.placements[i], y.to_local()
        if p.is_partial():
            out = funcol.wait_tensor(_reduce_scatter(local.contiguous(), p.reduce_op, 1,
                                                     (mesh, i)))
        else:
            out = local.chunk(mesh.size(i), dim=1)[mesh.get_local_rank(i)].contiguous()
        want = list(y.placements)
        want[i] = Shard(1)
        return _from_local(out, y, want)

    @staticmethod
    def backward(ctx, g: DTensor):
        (pin, mesh), i = ctx.y, ctx.i
        want = list(pin)
        want[i] = Shard(1)
        if tuple(g.placements) != tuple(want):
            g = g.redistribute(mesh, want)
        local = funcol.wait_tensor(_all_gather(g.to_local().contiguous(), 1, (mesh, i)))
        want[i] = Replicate()
        return _from_local(local, g, want), None


def gather_tokens(x: torch.Tensor) -> torch.Tensor:
    """A DTensor (b, ...) split on its batch alone: every other split (the
    sequence of sequence parallelism) gathered and partial sums reduced, once
    ahead of the projections that share it (DTensor redistributes an operand
    for each op that reads it, and does not reuse a gather across ops as XLA
    does). A sequence split over "model" goes through :class:`_SeqGather`.
    Anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    if tuple(x.placements) == want:
        return x
    i = _model_dim(x)
    if i is not None and x.placements[i] == Shard(1) and _seq_split(x, i):
        x = _SeqGather.apply(x, i)
        if tuple(x.placements) == want:
            return x
    return x.redistribute(x.device_mesh, want)


def scatter_tokens(y: torch.Tensor) -> torch.Tensor:
    """A sublayer's output (b, s, ...), a DTensor partial over "model" (a
    row-parallel projection's) or whole there (heads that do not split),
    reduce-scattered or sliced along s (:class:`_SeqScatter`) when s splits
    evenly over "model"; anything else as it is."""
    if not isinstance(y, DTensor):
        return y
    i = _model_dim(y)
    if i is None or isinstance(y.placements[i], Shard) or not _seq_split(y, i):
        return y
    return _SeqScatter.apply(y, i)


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


class _VocabParallelCE(torch.autograd.Function):
    """Each position's negative log-likelihood from logits split by
    vocabulary over a group (Megatron's vocab-parallel cross-entropy): x
    (..., V_local) f32 holds the vocabulary ``[offset, offset + V_local)``.
    The max and the sum of exponentials are all-reduced (MAX, SUM), and the
    label's logit comes from the rank whose range holds it (a masked gather,
    SUM): three (...) all-reduces in place of gathering (..., V). The
    backward is ``g (softmax_local - onehot_local)``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, labels: torch.Tensor, group: Any,
                offset: int) -> torch.Tensor:
        m = funcol.wait_tensor(funcol.all_reduce(x.amax(dim=-1), "max", group))
        e = torch.exp(x - m[..., None])
        se = funcol.wait_tensor(funcol.all_reduce(e.sum(dim=-1), "sum", group))
        local = labels - offset
        hit = (local >= 0) & (local < x.shape[-1])
        idx = torch.where(hit, local, torch.zeros_like(local))
        picked = torch.where(hit, torch.gather(x, -1, idx[..., None])[..., 0],
                             torch.zeros_like(m))
        picked = funcol.wait_tensor(funcol.all_reduce(picked, "sum", group))
        ctx.save_for_backward(e, se, idx, hit)
        return torch.log(se) + m - picked

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        e, se, idx, hit = ctx.saved_tensors
        grad = e * (g / se)[..., None]
        grad.scatter_add_(-1, idx[..., None], torch.where(hit, -g, torch.zeros_like(g))[..., None])
        return grad, None, None, None


def _vocab_nll(logits: DTensor, labels: torch.Tensor, j: int) -> DTensor:
    """:class:`_VocabParallelCE` on each rank's shards (``local_map``):
    logits split by vocabulary over mesh dimension ``j``; the labels placed
    as the logits without that split, and so is the output."""
    mesh = logits.device_mesh
    vocab = Shard(logits.ndim - 1)
    pl = tuple(logits.placements)
    plab = tuple(Replicate() if p == vocab else p for p in pl)

    def local(x: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
        offset = mesh.get_local_rank(j) * x.shape[-1]
        return _VocabParallelCE.apply(x, lab.clamp(min=0).long(), (mesh, j), offset)

    return run_local(local, mesh, (pl, plab), (plab,), logits, labels)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid positions (labels >= 0 unless a mask is given).
    Logits split by vocabulary over a mesh dimension (the meshed readout)
    take the vocab-parallel route (:func:`_vocab_nll`): nothing gathers
    them; anything else takes ``log_softmax``."""
    if isinstance(logits, DTensor):
        vocab = Shard(logits.ndim - 1)
        split = [j for j, p in enumerate(logits.placements)
                 if p == vocab and logits.device_mesh.size(j) > 1]
        if len(split) == 1 and logits.shape[-1] % logits.device_mesh.size(split[0]) == 0:
            nll = _vocab_nll(logits, labels, split[0])
            mask = (labels >= 0).float() if mask is None else mask.float()
            return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).float() if mask is None else mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
