"""Public selective-scan op: the Hopper kernels on CUDA, the plain versions
on the CPU.

A call that autograd will differentiate (grad mode on and any input
requiring a gradient) goes through :class:`SelectiveScan`: on the card its
forward is the kernel with the state entering each 64-step chunk kept
beside y, and its backward is the backward kernel (``selective_scan_bwd``);
on the CPU they are ``selective_scan_ref`` and ``selective_scan_bwd_ref``.
Any other call launches the forward alone, as inference always did."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .mamba_scan import mamba_selective_scan, selective_scan_bwd
from .ref import selective_scan_bwd_ref, selective_scan_ref


def _device_type(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"selective_scan runs on CUDA or CPU tensors, got {x.device}")
    return x.device.type


class SelectiveScan(torch.autograd.Function):
    """The scan with the kernels' forward and backward (the plain versions
    on the CPU). Outputs y and h_last; both may carry a gradient."""

    @staticmethod
    def forward(ctx, dt, Bm, Cm, x, A_log, D, out_dtype):
        ctx.set_materialize_grads(False)  # an unused h_last gives dh_last None
        if _device_type(x) == "cuda":
            y, h, h_chunks = mamba_selective_scan(dt, Bm, Cm, x, A_log, D, out_dtype,
                                                  return_chunk_states=True)
            ctx.save_for_backward(dt, Bm, Cm, x, A_log, D, h_chunks)
        else:
            y, h = selective_scan_ref(dt, Bm, Cm, x, A_log, D, out_dtype)
            ctx.save_for_backward(dt, Bm, Cm, x, A_log, D)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh_last):
        dt, Bm, Cm, x, A_log, D, *h_chunks = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(dt.shape, dtype=torch.float32, device=dt.device)
        if h_chunks:
            grads = selective_scan_bwd(dt, Bm, Cm, x, A_log, D, h_chunks[0], dy, dh_last)
        else:
            grads = selective_scan_bwd_ref(dt, Bm, Cm, x, A_log, D, dy, dh_last)
        return (*grads, None)


def selective_scan_op(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                      x: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba1 selective scan: (y (b, s, di) in ``out_dtype`` or x's
    dtype, h_last (b, di, n) f32)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dt, Bm, Cm, x, A_log, D)):
        return SelectiveScan.apply(dt, Bm, Cm, x, A_log, D, out_dtype or x.dtype)
    if _device_type(x) == "cuda":
        return mamba_selective_scan(dt, Bm, Cm, x, A_log, D, out_dtype)
    return selective_scan_ref(dt, Bm, Cm, x, A_log, D, out_dtype)
