"""Public selective-scan op: the Hopper kernel on CUDA, the plain version on CPU.

The kernel has no backward yet (ROADMAP Queue B, B6b), so on CUDA a call
that autograd would differentiate raises instead of returning a y with no
graph; the CPU's plain version stays differentiable."""
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
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (dt, Bm, Cm, x, A_log, D)):
            raise NotImplementedError(
                "selective_scan: the Hopper kernel has no backward yet (ROADMAP Queue B, "
                "B6b: the selective-scan backward); training an ssm model on the card "
                "waits for it")
        return mamba_selective_scan(dt, Bm, Cm, x, A_log, D, out_dtype)
    if x.device.type == "cpu":
        return selective_scan_ref(dt, Bm, Cm, x, A_log, D, out_dtype)
    raise ValueError(f"selective_scan runs on CUDA or CPU tensors, got {x.device}")
