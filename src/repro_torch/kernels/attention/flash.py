"""Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``repro.kernels.attention.flash.flash_attention`` (Pallas): blocked
causal / sliding-window / softcapped attention with an online softmax in
f32. Reads q, k and v in place through their strides and maps query head h
to kv head h // (H / KV), so GQA takes no expanded copy. Bound by
operations; the source file states the bound and the design. CUDA tensors
only: :mod:`.ops` dispatches.
"""
from __future__ import annotations

import torch

from .. import LAUNCHES
from .._build import check, lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (b, s_q, H, hd); k, v (b, s_kv, KV, hd), KV dividing H; one dtype
    (f32 or bf16). Returns (b, s_q, H, hd) contiguous in q's dtype."""
    if not (q.device.type == "cuda" and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: expected q, k and v on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         f"expected one of {list(_DTYPES)} for all three")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: expected q (b, s, H, hd) and k, v (b, s, KV, hd)")
    b, s_q, h, hd = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if h % kvh:
        raise ValueError(f"flash_attention: {kvh} kv heads do not divide {h} heads")
    if b > 65535 or h > 65535 or max(s_q, s_kv) >= 2 ** 31 or sliding_window < 0:
        raise ValueError("flash_attention: batch or heads above 65535, or a negative window")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    out = torch.empty((b, s_q, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() and s_kv:
        with torch.cuda.device(q.device):
            status = lib().rt_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s_q, s_kv, h, kvh, hd,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                int(causal), int(sliding_window), float(softcap), _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
        LAUNCHES["flash_attention"] += 1
        check(status, "flash_attention")
    return out
