"""GQA attention of the port (``repro.models.attention``): full sequence and
cached one-token decode, with sliding windows and the tanh logit softcap.

Every mask the flash kernel computes goes to the flash-attention op (the
Hopper kernel on the card, its plain version on the CPU):

* self-attention over positions ``arange(s)``, causal or not, windowed or
  not (every dense, moe and hybrid layer, whisper's encoder);
* cross-attention with no key positions (``kv_override`` and
  ``kv_positions=None``: whisper's decoder, prefill and decode), whose mask
  is all true whatever ``causal`` says, as in the JAX package: one
  non-causal call with s_q != s_kv;
* a bidirectional prefix of P positions with no window over ``arange(s)``
  (paligemma). Query q sees key k where k <= q or k < P: for q >= P that is
  k <= q (k < P <= q already implies it), for q < P it is k < P. So the
  output is a non-causal call over the first P queries and keys, then the
  rows from P on of a causal call over all of them; autograd sums dK and dV
  over the two.

Positions the forward made with :func:`arange_positions` are known to be
``arange(s)`` without reading them; any other positions are checked on
the device (a host read).

On a mesh (``layers.set_mesh_ctx``) q, k and v are pinned to the batch
axes and, when the heads divide "model", to heads over "model"
(``shard_hint``, as the JAX package's ``h_ax``), and the flash op runs each
rank's local heads through ``local_map`` (``kernels/attention/ops.py``).

A prefix with a window, any other positions, and cross-attention with key
positions take the masked einsum the JAX package uses everywhere
(``_attend_block``), as plain PyTorch. Decode self-attention attends one
token against the (ring-buffered when windowed) cache in plain PyTorch, as
the JAX package does.
"""
from __future__ import annotations

import weakref
from typing import Dict, Optional, Tuple

import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..dfl.sharding import axis_sizes
from ..kernels import run_local
from ..kernels.attention.ops import flash_attention_op, select_kv_heads
from .layers import Params, apply_rope, dense_init, gather_tokens, get_mesh_ctx, shard_hint

NEG_INF = -2.0e38
# a gather along a given dimension: all_gather_single in newer torch, which
# deprecates all_gather_tensor
_all_gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor


def init_attention(gen: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype: torch.dtype) -> Params:
    return {
        "wq": dense_init(gen, (d_model, n_heads, head_dim), dtype),
        "wk": dense_init(gen, (d_model, n_kv_heads, head_dim), dtype),
        "wv": dense_init(gen, (d_model, n_kv_heads, head_dim), dtype),
        "wo": dense_init(gen, (n_heads, head_dim, d_model), dtype),
    }


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def merge_heads(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", o, wo)`` as one matmul."""
    return o.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, s, kv, hd) -> (b, s, H, hd): head h reads kv head h // (H / kv),
    as ``jnp.repeat(k, g, axis=-2)``."""
    n_kv = k.shape[-2]
    if n_kv == n_heads:
        return k
    g = n_heads // n_kv
    return k.unsqueeze(-2).expand(*k.shape[:-1], g, k.shape[-1]).flatten(-3, -2)


def _divides(n_heads: int) -> bool:
    mesh, _ = get_mesh_ctx()
    sizes = axis_sizes(mesh) if mesh is not None else {}
    return "model" in sizes and n_heads % sizes["model"] == 0


def _hint_heads(n_heads: int, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """q, k, v (b, s, heads, hd) pinned to the batch axes, and to heads over
    "model" when the query heads divide it (each tensor's own head count
    checked again); the identity off a mesh."""
    h_ax = "model" if _divides(n_heads) else None
    return tuple(shard_hint(t, "batch", None, h_ax, None) for t in ts)


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(scores / cap) if cap > 0 else scores


# the positions tensors arange_positions made, by id (an entry leaves with
# its tensor)
_ARANGE: "weakref.WeakValueDictionary[int, torch.Tensor]" = weakref.WeakValueDictionary()


def arange_positions(b: int, s: int, device: torch.device) -> torch.Tensor:
    """(b, s) positions ``0, 1, ..., s-1`` a row, which the attention
    routing knows to be so without reading them."""
    positions = torch.arange(s, device=device).expand(b, s)
    _ARANGE[id(positions)] = positions
    return positions


def _is_arange(positions: torch.Tensor) -> bool:
    """Whether every row of (b, s) positions is ``0, 1, ..., s-1``: known
    for :func:`arange_positions`' tensors, else read from the device."""
    if _ARANGE.get(id(positions)) is positions:
        return True
    s = positions.shape[-1]
    return bool((positions == torch.arange(s, device=positions.device)).all())


def _attend_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, softcap: float) -> torch.Tensor:
    """q (b, q, H, hd), k/v (b, s, H, hd), mask (b, q, s): softmax in f32,
    output in q's dtype."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    scores = _softcap(scores, softcap)
    scores = scores.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def _prefix_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, prefix_len: int,
                  softcap: float) -> torch.Tensor:
    """Causal attention with the first ``prefix_len`` keys visible to every
    query, as two flash calls (see the module docstring)."""
    p = prefix_len
    head = flash_attention_op(q[:, :p], k[:, :p], v[:, :p], causal=False, sliding_window=0,
                              softcap=softcap)
    tail = flash_attention_op(q, k, v, causal=True, sliding_window=0, softcap=softcap)
    return torch.cat([head, tail[:, p:]], dim=1)


def attention(
    params: Params,
    x: torch.Tensor,  # (b, s, d)
    positions: torch.Tensor,  # (b, s)
    *,
    causal: bool = True,
    sliding_window: int = 0,
    softcap: float = 0.0,
    rope_theta: float = 10_000.0,
    use_rope: bool = True,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # cross-attention
    kv_positions: Optional[torch.Tensor] = None,
    prefix_len: int = 0,  # vlm: the first prefix_len positions attend bidirectionally
) -> torch.Tensor:
    """Full-sequence attention (prefill / encoder / cross): (b, s, d)."""
    x = gather_tokens(x)
    q = project_heads(x, params["wq"])
    if kv_override is None:
        k = project_heads(x, params["wk"])
        v = project_heads(x, params["wv"])
        kv_pos = positions
    else:
        k, v = kv_override
        kv_pos = kv_positions
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        if kv_override is None:
            k = apply_rope(k, kv_pos, rope_theta)
    q, k, v = _hint_heads(q.shape[2], q, k, v)

    if kv_override is not None and kv_positions is None:  # every key visible
        out = flash_attention_op(q, k, v, causal=False, sliding_window=0, softcap=softcap)
        return merge_heads(out, params["wo"])
    if kv_override is None and (prefix_len == 0 or (causal and sliding_window == 0)) \
            and _is_arange(positions):
        if prefix_len == 0:
            out = flash_attention_op(q, k, v, causal=causal, sliding_window=sliding_window,
                                     softcap=softcap)
        else:
            out = _prefix_flash(q, k, v, prefix_len, softcap)
        return merge_heads(out, params["wo"])

    b, s = q.shape[:2]
    s_kv = k.shape[1]
    mask = torch.ones((b, s, s_kv), dtype=torch.bool, device=x.device)
    if kv_pos is not None:
        kp, qp = kv_pos[:, None, :], positions[:, :, None]
        if causal:
            c = kp <= qp
            if prefix_len > 0:  # prefix tokens are mutually visible
                c = c | (kp < prefix_len)
            mask = mask & c
        if sliding_window > 0:
            w = kp > qp - sliding_window
            if prefix_len > 0:
                w = w | (kp < prefix_len)
            mask = mask & w
    n_heads = q.shape[2]
    out = _attend_masked(q, _expand_kv(k, n_heads), _expand_kv(v, n_heads), mask, softcap)
    return merge_heads(out, params["wo"])


def _cache_attend(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                  ck: torch.Tensor, cv: torch.Tensor, position: torch.Tensor, cache_len: int,
                  sliding_window: int, softcap: float, head_dim: int = 0, offset: int = 0,
                  select=None, psum_hd=None, seq_reduce=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The new token's k and v written into the cache (b, L, kv, hd) whose
    first slot is ``offset`` of ``cache_len``, then q (b, 1, H, hd) against
    it: (out (b, 1, H, hd) in q's dtype, new k, new v); scores scale by
    ``head_dim`` (q's last dimension when 0). On one rank the
    hooks are unset; a rank of a mesh passes ``select`` (its query heads'
    kv heads), ``psum_hd`` (the scores summed over an hd-split cache) and
    ``seq_reduce`` (max and sum over a sequence-split cache)."""
    idx = torch.arange(ck.shape[1], device=q.device)
    if offset:
        idx = idx + offset
    slot = position % cache_len if sliding_window > 0 else position
    hit = (idx[None, :] == slot[:, None])[:, :, None, None]  # (b, L, 1, 1)
    k = torch.where(hit, k_new.to(ck.dtype), ck)
    v = torch.where(hit, v_new.to(cv.dtype), cv)

    ka, va = (k, v) if select is None else select(k, v)
    n_heads = q.shape[2]
    kh = _expand_kv(ka, n_heads)
    vh = _expand_kv(va, n_heads)
    scores = torch.einsum("bqhk,blhk->bhql", q.float(), kh.float())
    if psum_hd is not None:
        scores = psum_hd(scores)
    scores = scores * (head_dim or q.shape[-1]) ** -0.5
    scores = _softcap(scores, softcap)
    valid = idx[None, :] <= position[:, None]
    if sliding_window > 0:
        # once the ring has wrapped every slot holds an in-window entry
        valid = valid | (position + 1 > cache_len)[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    if seq_reduce is None:
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhql,blhk->bqhk", probs, vh.float())
    else:  # the softmax over slots that other ranks hold
        pmax, psum = seq_reduce
        e = torch.exp(scores - pmax(scores.amax(dim=-1, keepdim=True)))
        out = psum(torch.einsum("bhql,blhk->bqhk", e, vh.float()))
        out = out / psum(e.sum(dim=-1, keepdim=True)).transpose(1, 2)
    return out.to(q.dtype), k, v


def _cache_attend_local(q: DTensor, k_new: DTensor, v_new: DTensor, ck: DTensor,
                        cv: DTensor, position: torch.Tensor, sliding_window: int,
                        softcap: float) -> Tuple[DTensor, DTensor, DTensor]:
    """:func:`_cache_attend` on each rank's shards (``local_map``), by the
    cache's placements a mesh dimension: batch (q, the new k and v, the
    positions split alike), kv heads (q on its heads), the cache's sequence
    (the softmax's max and sum and the output all-reduced), head_dim (q
    split on hd too, the scores all-reduced, the output gathered), or
    replicated (a rank whose query heads are split takes their kv heads).
    Returns out placed by batch and heads, and the cache as it was placed."""
    mesh = ck.device_mesh
    r = Replicate()
    pc = tuple(ck.placements)
    q_in = tuple(q.placements)
    pq, pn, pp = [], [], []  # q, the new k and v, the positions
    for i, p in enumerate(pc):
        if p == Shard(0):
            pq.append(p), pn.append(p), pp.append(p)
        elif p in (Shard(2), Shard(3)):
            pq.append(p), pn.append(p), pp.append(r)
        elif p == Shard(1) or isinstance(p, Replicate):
            pq.append(Shard(2) if isinstance(p, Replicate) and q_in[i] == Shard(2) else r)
            pn.append(r), pp.append(r)
        else:
            raise ValueError(f"decode attention: a cache placed {pc}")
    pq, pn, pp = tuple(pq), tuple(pn), tuple(pp)
    head_dims = [i for i, p in enumerate(pq) if p == Shard(2)]
    select_dims = [i for i in head_dims if isinstance(pc[i], Replicate)]
    hd_dims = [i for i, p in enumerate(pc) if p == Shard(3)]
    seq_dims = [i for i, p in enumerate(pc) if p == Shard(1)]
    pout = tuple(r if i in hd_dims else p for i, p in enumerate(pq))
    cache_len, group, head_dim = ck.shape[1], q.shape[2] // ck.shape[2], q.shape[3]

    def over(dims, op):
        def reduce(t):
            for i in dims:
                t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, i)))
            return t
        return reduce

    def local(q, k_new, v_new, ck, cv, position):
        c = 0
        for i in seq_dims:
            c = c * mesh.size(i) + mesh.get_local_rank(i)
        select = None
        if select_dims:
            def select(k, v):
                return select_kv_heads(k, v, mesh, head_dims, q.shape[2], group)
        out, k, v = _cache_attend(
            q, k_new, v_new, ck, cv, position, cache_len, sliding_window, softcap,
            head_dim=head_dim, offset=c * ck.shape[1], select=select,
            psum_hd=over(hd_dims, "sum") if hd_dims else None,
            seq_reduce=(over(seq_dims, "max"), over(seq_dims, "sum")) if seq_dims else None)
        for i in hd_dims:
            out = funcol.wait_tensor(_all_gather(out, 3, (mesh, i)))
        return out, k, v

    return run_local(local, mesh, (pq, pn, pn, pc, pc, pp), (pout, pc, pc),
                     q, k_new, v_new, ck, cv, position)


def init_kv_cache(batch: int, cache_len: int, n_kv_heads: int, head_dim: int,
                  dtype: torch.dtype, device=None) -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros((batch, cache_len, n_kv_heads, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, n_kv_heads, head_dim), dtype=dtype, device=device),
    }


def decode_attention(
    params: Params,
    x: torch.Tensor,  # (b, 1, d)
    position: torch.Tensor,  # (b,) absolute position of the new token
    cache: Dict[str, torch.Tensor],
    *,
    sliding_window: int = 0,
    softcap: float = 0.0,
    rope_theta: float = 10_000.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against the cache; returns (out, new cache).

    The cache stores rotated keys. Windowed layers write slot ``position %
    cache_len`` (a ring buffer), the others slot ``position``; a slot past
    the cache is not written, as the JAX package's one-hot blend writes
    nothing there."""
    n_heads = params["wq"].shape[1]
    cache_len = cache["k"].shape[1]
    q = project_heads(x, params["wq"])
    k_new = project_heads(x, params["wk"])
    v_new = project_heads(x, params["wv"])
    q = apply_rope(q, position[:, None], rope_theta)
    k_new = apply_rope(k_new, position[:, None], rope_theta)
    q, k_new, v_new = _hint_heads(n_heads, q, k_new, v_new)
    args = (q, k_new, v_new, cache["k"], cache["v"], position)
    if isinstance(cache["k"], DTensor):
        out, k, v = _cache_attend_local(*args, sliding_window, softcap)
    else:
        out, k, v = _cache_attend(*args, cache_len, sliding_window, softcap)
    return merge_heads(out, params["wo"]), {"k": k, "v": v}
