"""Public selective-scan op: the Hopper kernels on CUDA, the plain versions
on the CPU.

A call that autograd will differentiate (grad mode on and any input
requiring a gradient) goes through :class:`SelectiveScan`: on the card its
forward is the kernel with the state entering each 64-step chunk kept
beside y, and its backward is the backward kernel (``selective_scan_bwd``);
on the CPU they are ``selective_scan_ref`` and ``selective_scan_bwd_ref``.
Any other call launches the forward alone, as inference always did. A fake
tensor takes the kernels' fake route; each call is one
:class:`~repro_torch.kernels.kernel_call`.

DTensors (a meshed Mamba1 block) go through :func:`_scan_local`: x and dt
split on batch and ``d_inner``, ``A_log`` and D on ``d_inner``, B and C on
batch only (a ``d_inner``-split ``wB``/``wC`` leaves them partial sums, which
the redistribution all-reduces); each rank scans its own channels, and y
and h_last come back split as x is."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import kernel_call, on_card, run_local
from .mamba_scan import mamba_selective_scan, scan_bwd_cost, scan_cost, selective_scan_bwd
from .ref import selective_scan_bwd_ref, selective_scan_ref


class SelectiveScan(torch.autograd.Function):
    """The scan with the kernels' forward and backward (the plain versions
    on the CPU). Outputs y and h_last; both may carry a gradient."""

    @staticmethod
    def forward(ctx, dt, Bm, Cm, x, A_log, D, out_dtype):
        ctx.set_materialize_grads(False)  # an unused h_last gives dh_last None
        with kernel_call("selective_scan", scan_cost, dt, Bm, x, out_dtype, True):
            if on_card(x, "selective_scan"):
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
        with kernel_call("selective_scan_bwd", scan_bwd_cost, dt, Bm, x, dy, dh_last):
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
    if isinstance(x, DTensor):
        return _scan_local(dt, Bm, Cm, x, A_log, D, out_dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dt, Bm, Cm, x, A_log, D)):
        return SelectiveScan.apply(dt, Bm, Cm, x, A_log, D, out_dtype or x.dtype)
    with kernel_call("selective_scan", scan_cost, dt, Bm, x, out_dtype, False):
        if on_card(x, "selective_scan"):
            return mamba_selective_scan(dt, Bm, Cm, x, A_log, D, out_dtype)
        return selective_scan_ref(dt, Bm, Cm, x, A_log, D, out_dtype)


def _scan_local(dt: DTensor, Bm: DTensor, Cm: DTensor, x: DTensor, A_log: DTensor,
                D: DTensor, out_dtype: Optional[torch.dtype]) -> Tuple[DTensor, DTensor]:
    """The scan op on each rank's local batch rows and channels
    (``local_map``), placed by x's placements."""
    mesh = x.device_mesh
    px = tuple(x.placements)
    r = Replicate()
    by = {Shard(0): (Shard(0), r, Shard(0)),  # batch: (B and C, A_log and D, h_last)
          Shard(2): (r, Shard(0), Shard(1)),  # d_inner
          r: (r, r, r)}
    if any(p not in by for p in px):
        raise ValueError(f"selective_scan: x splits on batch or d_inner only, got {px}")
    pbc, pad, ph = (tuple(by[p][i] for p in px) for i in range(3))

    def local(dt, Bm, Cm, x, A_log, D):
        return selective_scan_op(dt, Bm, Cm, x, A_log, D, out_dtype)

    return run_local(local, mesh, (px, pbc, pbc, px, pad, pad), (px, ph),
                     dt, Bm, Cm, x, A_log, D)
