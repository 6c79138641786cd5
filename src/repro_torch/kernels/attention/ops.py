"""Public flash-attention op: the Hopper kernels on CUDA, the plain versions
on the CPU.

A call that autograd will differentiate (grad mode on and q, k or v
requiring a gradient) goes through :class:`FlashAttention`: its forward
keeps the rows' log-sum-exp beside the output, and its backward is the
backward kernel on the card (``flash_attention_bwd``) and
``attention_bwd_ref`` on the CPU. Any other call launches the forward
alone, as inference always did. A fake tensor takes the kernels' fake
route; each call is one :class:`~repro_torch.kernels.kernel_call`.
"""
from __future__ import annotations

import torch

from .. import kernel_call, on_card
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, sliding_window, softcap)
    with kernel_call("flash_attention", flash_cost, q, k, causal, sliding_window, False):
        if on_card(q, "flash_attention"):
            return flash_attention(q, k, v, **kw)
        return attention_ref(q, k, v, **kw)
