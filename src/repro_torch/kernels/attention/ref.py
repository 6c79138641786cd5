"""Plain PyTorch version of the flash-attention kernel."""
from __future__ import annotations

import torch

NEG_INF = -1.0e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sliding_window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q (b, s_q, H, hd); k, v (b, s_kv, KV, hd) with KV dividing H (query
    head h reads kv head h // (H / KV)). Scores, softcap, mask and softmax
    in f32; the output in q's dtype, (b, s_q, H, hd)."""
    n_heads, n_kv = q.shape[2], k.shape[2]
    if n_heads % n_kv:
        raise ValueError(f"attention_ref: {n_kv} kv heads do not divide {n_heads} heads")
    if n_kv != n_heads:  # head h reads kv head h // g
        g = n_heads // n_kv
        k = k.unsqueeze(3).expand(*k.shape[:3], g, k.shape[3]).flatten(2, 3)
        v = v.unsqueeze(3).expand(*v.shape[:3], g, v.shape[3]).flatten(2, 3)
    s_q, s_kv, hd = q.shape[1], k.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(s_q, device=q.device)[:, None]
    k_pos = torch.arange(s_kv, device=q.device)[None, :]
    mask = torch.ones((s_q, s_kv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if sliding_window > 0:
        mask &= k_pos > q_pos - sliding_window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
