"""Hopper flash-attention kernels (``csrc/flash_attention.cu``).

Replaces ``repro.kernels.attention.flash.flash_attention`` (Pallas): blocked
causal / sliding-window / softcapped attention with an online softmax in
f32. Reads q, k and v in place through their strides and maps query head h
to kv head h // (H / KV), so GQA takes no expanded copy. Bound by
operations; the source file states the bound and the design. The dtype
picks the kernel: bf16 runs on the tensor cores (wgmma fed by TMA), f32 on
the SIMT kernel. TMA takes bf16 tensors whose base is 16-byte aligned and
whose strides are multiples of 8 elements; any other bf16 layout raises.
CUDA tensors only: :mod:`.ops` dispatches.
"""
from __future__ import annotations

import torch

from .. import count_launch
from .._build import check, lib

_ENTRY = {torch.float32: "rt_flash_attention_f32", torch.bfloat16: "rt_flash_attention_bf16"}
HEAD_DIMS = (32, 64, 128, 256)


def _check_tma_layout(*tensors: torch.Tensor) -> None:
    """TMA reads a bf16 tensor from a 16-byte-aligned base with (b, s, h)
    strides that are multiples of 16 bytes (a stride of an extent-1 dim is
    never stepped)."""
    for t in tensors:
        strides = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if t.data_ptr() % 16 or any(st % 8 for st in strides):
            raise ValueError(
                f"flash_attention: a bf16 view with base offset {t.data_ptr() % 16} B and "
                f"strides {tuple(t.stride())}; the tensor-core kernel needs a 16-byte-aligned "
                "base and (b, s, h) strides that are multiples of 8 elements")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (b, s_q, H, hd); k, v (b, s_kv, KV, hd), KV dividing H; one dtype
    (f32 or bf16). Returns (b, s_q, H, hd) contiguous in q's dtype."""
    if not (q.device.type == "cuda" and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: expected q, k and v on one CUDA device")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         f"expected one of {list(_ENTRY)} for all three")
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
    if q.dtype == torch.bfloat16:
        _check_tma_layout(q, k, v)
    out = torch.empty((b, s_q, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() and s_kv:
        with torch.cuda.device(q.device):
            status = getattr(lib(), _ENTRY[q.dtype])(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s_q, s_kv, h, kvh, hd,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                int(causal), int(sliding_window), float(softcap),
                torch.cuda.current_stream(q.device).cuda_stream)
        count_launch("flash_attention", (b, s_q, s_kv, h, kvh, hd))
        check(status, "flash_attention")
    return out
