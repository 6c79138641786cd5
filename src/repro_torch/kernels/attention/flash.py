"""Hopper flash-attention kernels (``csrc/flash_attention.cu``).

Replaces ``repro.kernels.attention.flash.flash_attention`` (Pallas): blocked
causal / sliding-window / softcapped attention with an online softmax in
f32. Reads q, k and v in place through their strides and maps query head h
to kv head h // (H / KV), so GQA takes no expanded copy. Bound by
operations; the source file states the bound and the design. The dtype
picks the kernel: bf16 runs on the tensor cores (wgmma fed by TMA), f32 on
the SIMT kernel. TMA takes bf16 tensors whose base is 16-byte aligned and
whose strides are multiples of 8 elements; any other bf16 layout raises.
With ``return_lse`` the forward also writes each row's log-sum-exp.

:func:`flash_attention_bwd` binds ``csrc/flash_attention_bwd.cu``: dQ, dK
and dV from q, k, v, the output, its LSE and dO, in two launches (dQ, then
dK and dV); bf16 runs on the tensor cores (wgmma fed by TMA), f32 on SIMT
kernels. The JAX package has no backward kernel (its trainer differentiates
einsum attention); bound by operations, the source states the bound and the
design. CUDA tensors only: :mod:`.ops` dispatches. A fake tensor takes the
fake route: the outputs and the D scratch, no launch.

:func:`flash_cost` and :func:`flash_bwd_cost` give one launch's FLOPs (4 hd
and 10 hd a visible (query, key) pair a head) and bytes.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .. import Cost, count_launch, is_fake
from .._build import check, lib

_ENTRY = {torch.float32: "rt_flash_attention_f32", torch.bfloat16: "rt_flash_attention_bf16"}
# the head dims the kernels are built for; 112 and 160 run padded to whole
# 64-column slabs inside the kernels (the sources say how), never in memory
HEAD_DIMS = (32, 64, 112, 128, 160, 256)


@functools.lru_cache(maxsize=1024)
def visible_pairs(s_q: int, s_kv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the masks leave visible: keys k < s_kv with
    k <= q when causal and k > q - window when windowed."""
    q = np.arange(s_q, dtype=np.int64)
    hi = np.minimum(q + 1, s_kv) if causal else np.full_like(q, s_kv)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    return int(np.maximum(hi - lo, 0).sum())


def flash_cost(q: torch.Tensor, k: torch.Tensor, causal: bool, sliding_window: int,
               lse: bool) -> Optional[Cost]:
    """One forward launch: q, k, v read and the output (and its LSE) written
    once; 4 hd operations a visible pair a head (Q K^T and P V). None where
    the wrapper launches nothing."""
    b, s_q, h, hd = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    if not (b * s_q * h * hd and s_kv):
        return None
    pairs = visible_pairs(s_q, s_kv, causal, sliding_window)
    n_bytes = (2 * b * s_q * h + 2 * b * s_kv * kvh) * hd * q.element_size()
    return Cost(4 * hd * b * h * pairs, n_bytes + (4 * b * h * s_q if lse else 0))


def flash_bwd_cost(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   sliding_window: int) -> Optional[Cost]:
    """One backward launch: q, k, v, the output, its LSE and dO read, dQ,
    dK and dV written once; 10 hd operations a visible pair a head (S and
    dP recomputed, dV, dQ, dK)."""
    b, s_q, h, hd = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    if not (b * s_q * h * hd and s_kv):
        return None
    pairs = visible_pairs(s_q, s_kv, causal, sliding_window)
    n_bytes = (4 * b * s_q * h + 4 * b * s_kv * kvh) * hd * q.element_size() + 4 * b * h * s_q
    return Cost(10 * hd * b * h * pairs, n_bytes)


def _addr(t: torch.Tensor) -> int:
    """The address of a tensor's first element; of a fake one, its offset
    from its storage's base (which the caching allocator aligns to 512 B)."""
    return t.storage_offset() * t.element_size() if is_fake(t) else t.data_ptr()


def _check_tma_layout(*tensors: torch.Tensor) -> None:
    """TMA reads a bf16 tensor from a 16-byte-aligned base with (b, s, h)
    strides that are multiples of 16 bytes (a stride of an extent-1 dim is
    never stepped)."""
    for t in tensors:
        strides = [st for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
        if _addr(t) % 16 or any(st % 8 for st in strides):
            raise ValueError(
                f"flash_attention: a bf16 view with base offset {_addr(t) % 16} B and "
                f"strides {tuple(t.stride())}; the tensor-core kernel needs a 16-byte-aligned "
                "base and (b, s, h) strides that are multiples of 8 elements")


def _check_inputs(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sliding_window: int) -> None:
    if not ((q.device.type == "cuda" or is_fake(q)) and k.device == q.device
            and v.device == q.device):
        raise ValueError(f"{name}: expected q, k and v on one CUDA device")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         f"expected one of {list(_ENTRY)} for all three")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: expected q (b, s, H, hd) and k, v (b, s, KV, hd)")
    b, s_q, h, hd = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"{name}: k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if h % kvh:
        raise ValueError(f"{name}: {kvh} kv heads do not divide {h} heads")
    if b > 65535 or h > 65535 or max(s_q, s_kv) >= 2 ** 31 or sliding_window < 0:
        raise ValueError(f"{name}: batch or heads above 65535, or a negative window")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0, softcap: float = 0.0,
                    return_lse: bool = False
                    ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q (b, s_q, H, hd); k, v (b, s_kv, KV, hd), KV dividing H; one dtype
    (f32 or bf16). Returns (b, s_q, H, hd) contiguous in q's dtype and, with
    ``return_lse``, the rows' log-sum-exp (b, H, s_q) f32."""
    _check_inputs("flash_attention", q, k, v, sliding_window)
    b, s_q, h, hd = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    if q.dtype == torch.bfloat16:
        _check_tma_layout(q, k, v)
    out = torch.empty((b, s_q, h, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() and s_kv and not is_fake(q):
        with torch.cuda.device(q.device):
            status = getattr(lib(), _ENTRY[q.dtype])(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                b, s_q, s_kv, h, kvh, hd,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                int(causal), int(sliding_window), float(softcap),
                torch.cuda.current_stream(q.device).cuda_stream)
        count_launch("flash_attention", (b, s_q, s_kv, h, kvh, hd))
        check(status, "flash_attention")
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                        sliding_window: int = 0, softcap: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK and dV of :func:`flash_attention` (same arguments) at the
    output ``o``, its LSE (b, H, s_q) f32 and the output's gradient ``do``;
    each in the input dtype, contiguous. Inputs that are not contiguous, or
    start off a 16-byte boundary, are copied first."""
    _check_inputs("flash_attention_bwd", q, k, v, sliding_window)
    b, s_q, h, hd = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, s_q):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do {tuple(do.shape)} or "
                         f"lse {tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32 \
            or any(t.device != q.device for t in (o, lse, do)):
        raise ValueError("flash_attention_bwd: o and do in q's dtype, lse f32, all on q's device")
    # contiguous, from a 16-byte-aligned base (TMA's rule, and the dQ pass
    # reads o and dO 16 bytes a thread)
    q, k, v, o, lse, do = (t.contiguous() if t.is_contiguous() and _addr(t) % 16 == 0
                           else t.clone(memory_format=torch.contiguous_format)
                           for t in (q, k, v, o, lse, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if not (q.numel() and s_kv):
        return dq.zero_(), dk.zero_(), dv.zero_()
    dd = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)  # D, pass 1 -> 2
    if is_fake(q):
        return dq, dk, dv
    with torch.cuda.device(q.device):
        status = lib().rt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dd.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None, b, s_q, s_kv, h, kvh, hd, int(causal), int(sliding_window), float(softcap),
            0 if q.dtype == torch.float32 else 1,
            torch.cuda.current_stream(q.device).cuda_stream)
    count_launch("flash_attention_bwd", (b, s_q, s_kv, h, kvh, hd))
    check(status, "flash_attention_bwd")
    return dq, dk, dv
