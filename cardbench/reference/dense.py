"""Plain reference of the dense decoder as the port states it (granite-3-2b).

Per layer: ``x += attn(rms(x))``, ``x += mlp(rms(x))``; then a final RMS
norm and the tied head. RMS norm is ``x / sqrt(mean(x^2) + eps) * (1 +
g)``. Attention: grouped-query (query head h reads key/value head
``h // (heads / kv_heads)``), rotary embeddings on interleaved pairs
``(x[2i], x[2i + 1])`` with ``theta ** (-2i / head_dim)``, causal softmax of
``q.k / sqrt(head_dim)``. The MLP is SwiGLU, ``(silu(x wg) * (x wi)) wo``.
The logits cover the published vocabulary; the embedding's padded rows
never reach them. Granite's published scalar multipliers (embedding,
attention, residual, logits) are not in the port's model and not here
(PERF.md lists them as departures).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from .numerics import MatMul


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + g)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (b, s, h, hd) rotated by position along s, interleaved pairs."""
    s, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)


def attention(p: Dict[str, torch.Tensor], x: torch.Tensor, theta: float,
              mm: MatMul) -> torch.Tensor:
    b, s, d = x.shape
    h, hd = p["wq"].shape[1], p["wq"].shape[2]
    kv = p["wk"].shape[1]
    q = rope(mm(x, p["wq"].reshape(d, h * hd)).view(b, s, h, hd), theta)
    k = rope(mm(x, p["wk"].reshape(d, kv * hd)).view(b, s, kv, hd), theta)
    v = mm(x, p["wv"].reshape(d, kv * hd)).view(b, s, kv, hd)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * hd)
    return mm(o, p["wo"].reshape(h * hd, d))


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, mm: MatMul) -> torch.Tensor:
    return mm(F.silu(mm(x, p["wg"])) * mm(x, p["wi"]), p["wo"])


def layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def loss(params: Dict[str, Any], hf: Dict[str, Any], tokens: torch.Tensor,
         labels: torch.Tensor, mm: MatMul) -> torch.Tensor:
    """Mean cross-entropy over the labels >= 0 of (b, s) tokens."""
    eps, theta = hf["rms_norm_eps"], hf["rope_theta"]
    table = params["embed"]["table"]
    x = table[tokens]
    for i in range(hf["num_hidden_layers"]):
        blk = layer(params["blocks"], i)
        x = x + attention(blk["attn"], rms_norm(x, blk["ln1"], eps), theta, mm)
        x = x + mlp(blk["mlp"], rms_norm(x, blk["ln2"], eps), mm)
    x = rms_norm(x, params["final_norm"], eps)
    logits = mm(x, table[:hf["vocab_size"]].t())
    return cross_entropy(logits, labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels >= 0
    ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    return -(ll * valid).sum() / valid.sum().clamp(min=1)
