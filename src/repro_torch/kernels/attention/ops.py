"""Public flash-attention op: the Hopper kernel on CUDA, the plain version on CPU."""
from __future__ import annotations

import torch

from .flash import flash_attention
from .ref import attention_ref


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, sliding_window: int = 0,
                       softcap: float = 0.0) -> torch.Tensor:
    """Attention over q (b, s_q, H, hd) and k, v (b, s_kv, KV, hd):
    (b, s_q, H, hd) in q's dtype."""
    kw = dict(causal=causal, sliding_window=sliding_window, softcap=softcap)
    if q.device.type == "cuda":
        return flash_attention(q, k, v, **kw)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, **kw)
    raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
