"""Plain PyTorch version of the flash-attention kernel, and the measure that
holds the bf16 kernel to it."""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1.0e30
# bf16's unit roundoff: 8 significant bits, so rounding moves a value by at
# most 2^-8 of itself
BF16_U = 2.0 ** -8
# the most rounding units (see rounding_units) a sound bf16 kernel may read
BF16_UNITS_TOL = 4.0


def _probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           sliding_window: int, softcap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The softmax probabilities (b, H, s_q, s_kv) and the f32 values with kv
    heads expanded to H, (b, s_kv, H, hd)."""
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
    return torch.softmax(s, dim=-1), v.float()


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sliding_window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q (b, s_q, H, hd); k, v (b, s_kv, KV, hd) with KV dividing H (query
    head h reads kv head h // (H / KV)). Scores, softcap, mask and softmax
    in f32; the output in q's dtype, (b, s_q, H, hd)."""
    p, vf = _probs(q, k, v, causal, sliding_window, softcap)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def rounding_units(out: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, sliding_window: int = 0,
                   softcap: float = 0.0) -> float:
    """The largest error of a bf16 attention output ``out`` against the f32
    attention o of the same inputs, in units of what the tensor-core
    kernel's two roundings can move it: BF16_U of |o| (the output's own
    rounding) plus BF16_U of sqrt(sum_k p_k^2 v_k^2) (P rounded to bf16
    before P V; the p_k round independently, so their errors add as a root
    sum of squares). Each element is held to its own scale, so a row that
    averages thousands of keys, whose |o| is small, is held as tightly as a
    row of a few keys. A sound kernel reads a few units at most; one key
    tile dropped from a 4096-key window reads tens."""
    p, vf = _probs(q, k, v, causal, sliding_window, softcap)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    spread = torch.einsum("bhqk,bkhd->bqhd", p * p, vf * vf).sqrt()
    scale = (BF16_U * (o.abs() + spread)).clamp_min(1e-30)
    return float(((out.float() - o).abs() / scale).max())
