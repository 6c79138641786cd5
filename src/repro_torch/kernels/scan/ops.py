"""Public selective-scan op: the Hopper kernel on CUDA, the plain version on CPU."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .mamba_scan import mamba_selective_scan
from .ref import selective_scan_ref


def selective_scan_op(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                      x: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba1 selective scan: (y (b, s, di) in ``out_dtype`` or x's
    dtype, h_last (b, di, n) f32)."""
    if x.device.type == "cuda":
        return mamba_selective_scan(dt, Bm, Cm, x, A_log, D, out_dtype)
    if x.device.type == "cpu":
        return selective_scan_ref(dt, Bm, Cm, x, A_log, D, out_dtype)
    raise ValueError(f"selective_scan runs on CUDA or CPU tensors, got {x.device}")
