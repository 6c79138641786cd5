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

from ..kernels.attention.ops import flash_attention_op
from .layers import Params, apply_rope, dense_init

NEG_INF = -2.0e38


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

    idx = torch.arange(cache_len, device=x.device)
    slot = position % cache_len if sliding_window > 0 else position
    hit = (idx[None, :] == slot[:, None])[:, :, None, None]  # (b, L, 1, 1)
    k = torch.where(hit, k_new.to(cache["k"].dtype), cache["k"])
    v = torch.where(hit, v_new.to(cache["v"].dtype), cache["v"])

    kh = _expand_kv(k, n_heads)
    vh = _expand_kv(v, n_heads)
    scores = torch.einsum("bqhk,blhk->bhql", q.float(), kh.float()) * q.shape[-1] ** -0.5
    scores = _softcap(scores, softcap)
    valid = idx[None, :] <= position[:, None]
    if sliding_window > 0:
        # once the ring has wrapped every slot holds an in-window entry
        valid = valid | (position + 1 > cache_len)[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhql,blhk->bqhk", probs, vh.float()).to(x.dtype)
    return merge_heads(out, params["wo"]), {"k": k, "v": v}
