"""Hopper selective-scan kernel (``csrc/selective_scan.cu``).

Replaces ``repro.kernels.scan.mamba_scan.mamba_selective_scan`` (Pallas):
the Mamba1 recurrence with the state kept on chip for the whole sequence,
``D x`` added in the kernel, y written in the dtype the caller asks for
(the TPU kernel writes x's dtype) and the last state returned in f32.
Bound by bytes; the source file states the bound and the design. CUDA
tensors only: :mod:`.ops` dispatches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import count_launch
from .._build import check, lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32


def mamba_selective_scan(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                         x: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt (b, s, di) f32, Bm/Cm (b, s, n) f32, x (b, s, di) f32 or bf16,
    A_log (di, n) f32, D (di,) f32. Returns y (b, s, di) in ``out_dtype``
    (x's dtype by default) and h_last (b, di, n) f32."""
    tensors = (dt, Bm, Cm, x, A_log, D)
    if any(t.device.type != "cuda" or t.device != dt.device for t in tensors):
        raise ValueError("selective_scan: expected every input on one CUDA device")
    out_dtype = out_dtype or x.dtype
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"selective_scan: x {x.dtype} / y {out_dtype} not in {list(_DTYPES)}")
    if any(t.dtype != torch.float32 for t in (dt, Bm, Cm, A_log, D)):
        raise ValueError("selective_scan: dt, B, C, A_log and D must be float32")
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"selective_scan: dt {tuple(dt.shape)} and x {tuple(x.shape)} "
                         "must both be (b, s, di)")
    b, s, di = dt.shape
    n = Bm.shape[-1]
    if Bm.shape != (b, s, n) or Cm.shape != (b, s, n) or A_log.shape != (di, n) \
            or D.shape != (di,):
        raise ValueError("selective_scan: B/C (b, s, n), A_log (di, n) or D (di,) mismatch")
    if not 1 <= n <= MAX_STATE or b > 65535 or max(s, di) >= 2 ** 31:
        raise ValueError(f"selective_scan: state size {n} not in 1..{MAX_STATE}, "
                         "batch above 65535 or a length above 2**31")
    dt, Bm, Cm, x, A_log, D = (t.contiguous() for t in tensors)
    y = torch.empty((b, s, di), dtype=out_dtype, device=x.device)
    h = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    if b and di:
        with torch.cuda.device(x.device):
            status = lib().rt_selective_scan(
                dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.data_ptr(),
                A_log.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(),
                b, s, di, n, _DTYPES[x.dtype], _DTYPES[out_dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
        count_launch("selective_scan", (b, s, di, n))
        check(status, "selective_scan")
    return y, h
