"""Plain PyTorch versions of the flash-attention kernels (forward, forward
with the rows' log-sum-exp, backward), and the measure that holds the bf16
forward kernel to its plain version."""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1.0e30
# bf16's unit roundoff: 8 significant bits, so rounding moves a value by at
# most 2^-8 of itself
BF16_U = 2.0 ** -8
# the most rounding units (see rounding_units) a sound bf16 kernel may read
BF16_UNITS_TOL = 4.0
# the backward kernel's largest error in each of dQ, dK and dV, as a fraction
# of that gradient's max |g|. f32: another sum order (measured on the card
# at 2.5e-6). bf16: the output's rounding moves an element by up to one bf16
# step, 2^-7 of the largest gradient at worst, and the tensor-core passes
# round P and dX to bf16 before their products; measured on the card at
# 7.3e-3 (dK, smollm's shape), against 2.2e-2 and up for planted faults that
# drop one of a key's 32 query tiles or widen the window by one key
# (PERF.md, python -m repro_torch.kernels.variants)
BWD_F32_TOL = 1e-4
BWD_BF16_TOL = 1.5e-2


def _expand(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, s, KV, hd) -> (b, s, H, hd) f32: head h reads kv head h // (H / KV)."""
    n_kv = t.shape[2]
    if n_heads % n_kv:
        raise ValueError(f"attention_ref: {n_kv} kv heads do not divide {n_heads} heads")
    if n_kv != n_heads:
        g = n_heads // n_kv
        t = t.unsqueeze(3).expand(*t.shape[:3], g, t.shape[3]).flatten(2, 3)
    return t.float()


def _mask(s_q: int, s_kv: int, causal: bool, sliding_window: int,
          device: torch.device) -> torch.Tensor:
    """(s_q, s_kv) bool: which keys each query sees."""
    q_pos = torch.arange(s_q, device=device)[:, None]
    k_pos = torch.arange(s_kv, device=device)[None, :]
    mask = torch.ones((s_q, s_kv), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if sliding_window > 0:
        mask &= k_pos > q_pos - sliding_window
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, sliding_window: int,
            softcap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The softcapped scores t (b, H, s_q, s_kv) f32, NEG_INF where masked,
    and the mask."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand(k, q.shape[2])) * q.shape[3] ** -0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    mask = _mask(q.shape[1], k.shape[1], causal, sliding_window, q.device)
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask


def _probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           sliding_window: int, softcap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The softmax probabilities (b, H, s_q, s_kv) and the f32 values with kv
    heads expanded to H, (b, s_kv, H, hd)."""
    s, _ = _scores(q, k, causal, sliding_window, softcap)
    return torch.softmax(s, dim=-1), _expand(v, q.shape[2])


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sliding_window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q (b, s_q, H, hd); k, v (b, s_kv, KV, hd) with KV dividing H (query
    head h reads kv head h // (H / KV)). Scores, softcap, mask and softmax
    in f32; the output in q's dtype, (b, s_q, H, hd), contiguous as the
    kernels write it."""
    p, vf = _probs(q, k, v, causal, sliding_window, softcap)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype).contiguous()


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, sliding_window: int = 0,
                      softcap: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention_ref` and the rows' log-sum-exp of the softcapped,
    masked scores, (b, H, s_q) f32: what the forward kernel writes when
    asked for it."""
    s, _ = _scores(q, k, causal, sliding_window, softcap)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, _expand(v, q.shape[2])).to(q.dtype).contiguous()
    return out, lse


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                      lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                      sliding_window: int = 0, softcap: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK and dV of :func:`attention_ref` at the output ``o`` (its
    value, as the forward returned it), the rows' LSE (b, H, s_q) and the
    output's gradient ``do``; in f32, each returned in its input's dtype.
    Step by step, as the backward kernel computes it:

      x = q k^T hd^-0.5;  t = c tanh(x / c) (softcap c > 0) else x
      P = exp(t - LSE), 0 where masked
      dV = P^T dO;  dP = dO V^T;  D = rowsum(dO o O);  dT = P (dP - D)
      dX = dT (1 - (t / c)^2) (softcap) else dT
      dQ = dX K hd^-0.5;  dK = dX^T Q hd^-0.5

    dK and dV of a kv head sum over its H / KV query heads."""
    n_heads, n_kv, hd = q.shape[2], k.shape[2], q.shape[3]
    scale = hd ** -0.5
    kf, vf, qf, dof = _expand(k, n_heads), _expand(v, n_heads), q.float(), do.float()
    t = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if softcap > 0:
        t = softcap * torch.tanh(t / softcap)
    mask = _mask(q.shape[1], k.shape[1], causal, sliding_window, q.device)
    p = torch.where(mask, torch.exp(t - lse[..., None]), torch.zeros_like(t))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    d = (dof * o.float()).sum(dim=-1).transpose(1, 2)  # (b, H, s_q)
    dx = p * (dp - d[..., None])
    if softcap > 0:
        dx = dx * (1.0 - (t / softcap) ** 2)
    dq = torch.einsum("bhqk,bkhd->bqhd", dx, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dx, qf) * scale
    if n_kv != n_heads:  # sum over each kv head's query heads
        g = n_heads // n_kv
        dk = dk.unflatten(2, (n_kv, g)).sum(dim=3)
        dv = dv.unflatten(2, (n_kv, g)).sum(dim=3)
    return (dq.to(q.dtype).contiguous(), dk.to(k.dtype).contiguous(),
            dv.to(v.dtype).contiguous())


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
