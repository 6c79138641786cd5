"""Hopper selective-scan kernels: the forward (``csrc/selective_scan.cu``)
and its backward (``csrc/selective_scan_bwd.cu``).

The forward replaces ``repro.kernels.scan.mamba_scan.mamba_selective_scan``
(Pallas): the Mamba1 recurrence with the state kept on chip for the whole
sequence, ``D x`` added in the kernel, y written in the dtype the caller
asks for (the TPU kernel writes x's dtype), the last state returned in f32
and, when asked, the state entering each 64-step chunk, which the backward
reads. The backward has no TPU counterpart (XLA differentiates the JAX
package's jnp scan). Both are bound by bytes; the source files state the
bounds and the designs. CUDA tensors only: :mod:`.ops` dispatches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import count_launch
from .._build import check, lib

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32
CHUNK = 64  # steps a chunk: the forward's h_chunks hold the state entering each


def mamba_selective_scan(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                         x: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                         out_dtype: Optional[torch.dtype] = None, *,
                         return_chunk_states: bool = False):
    """dt (b, s, di) f32, Bm/Cm (b, s, n) f32, x (b, s, di) f32 or bf16,
    A_log (di, n) f32, D (di,) f32. Returns y (b, s, di) in ``out_dtype``
    (x's dtype by default) and h_last (b, di, n) f32, and with
    ``return_chunk_states`` also h_chunks (b, ceil(s / 64), di, n) f32, the
    state entering each chunk of 64 steps (y is the same bit for bit)."""
    _check_scan_inputs("selective_scan", dt, Bm, Cm, x, A_log, D)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPES:
        raise ValueError(f"selective_scan: y {out_dtype} not in {list(_DTYPES)}")
    dt, Bm, Cm, x, A_log, D = (t.contiguous() for t in (dt, Bm, Cm, x, A_log, D))
    b, s, di = dt.shape
    n = Bm.shape[-1]
    y = torch.empty((b, s, di), dtype=out_dtype, device=x.device)
    h = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    hc = (torch.empty((b, -(-s // CHUNK), di, n), dtype=torch.float32, device=x.device)
          if return_chunk_states else None)
    if b and di:
        with torch.cuda.device(x.device):
            status = lib().rt_selective_scan(
                dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.data_ptr(),
                A_log.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(),
                None if hc is None else hc.data_ptr(),
                b, s, di, n, _DTYPES[x.dtype], _DTYPES[out_dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
        count_launch("selective_scan", (b, s, di, n))
        check(status, "selective_scan")
    return (y, h, hc) if return_chunk_states else (y, h)


def selective_scan_bwd(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                       x: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                       h_chunks: torch.Tensor, dy: torch.Tensor,
                       dh_last: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """The scan's gradient: the forward's inputs, its chunk states h_chunks
    (b, ceil(s / 64), di, n) f32, dy (b, s, di) f32 or bf16 and dh_last
    (b, di, n) f32 or None (zero). Returns (ddt, dB, dC, dx, dA_log, dD):
    dx in x's dtype, the rest f32. Deterministic: two calls on the same
    inputs give the same bits."""
    _check_scan_inputs("selective_scan_bwd", dt, Bm, Cm, x, A_log, D, h_chunks, dy, dh_last)
    b, s, di = dt.shape
    n = Bm.shape[-1]
    if dy.dtype not in _DTYPES or dy.shape != (b, s, di):
        raise ValueError(f"selective_scan_bwd: dy {dy.dtype} {tuple(dy.shape)} is not "
                         f"(b, s, di) in {list(_DTYPES)}")
    if h_chunks.dtype != torch.float32 or h_chunks.shape != (b, -(-s // CHUNK), di, n):
        raise ValueError(f"selective_scan_bwd: h_chunks {tuple(h_chunks.shape)} is not "
                         "(b, ceil(s / 64), di, n) f32")
    if dh_last is not None and (dh_last.dtype != torch.float32 or dh_last.shape != (b, di, n)):
        raise ValueError("selective_scan_bwd: dh_last must be (b, di, n) f32")
    dt, Bm, Cm, x, A_log, D, h_chunks, dy = (
        t.contiguous() for t in (dt, Bm, Cm, x, A_log, D, h_chunks, dy))
    dh_last = None if dh_last is None else dh_last.contiguous()
    dev = x.device
    ddt = torch.empty((b, s, di), dtype=torch.float32, device=dev)
    dx = torch.empty((b, s, di), dtype=x.dtype, device=dev)
    dB = torch.empty((b, s, n), dtype=torch.float32, device=dev)
    dC = torch.empty((b, s, n), dtype=torch.float32, device=dev)
    dA_log = torch.empty((di, n), dtype=torch.float32, device=dev)
    dD = torch.empty((di,), dtype=torch.float32, device=dev)
    if b and di:
        work_elems = lib().rt_selective_scan_bwd_workspace(b, s, di, n)
        work = torch.empty((work_elems,), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            status = lib().rt_selective_scan_bwd(
                dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), x.data_ptr(), A_log.data_ptr(),
                D.data_ptr(), h_chunks.data_ptr(), dy.data_ptr(),
                None if dh_last is None else dh_last.data_ptr(),
                ddt.data_ptr(), dx.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA_log.data_ptr(),
                dD.data_ptr(), work.data_ptr(), work_elems, b, s, di, n,
                _DTYPES[x.dtype], _DTYPES[dy.dtype],
                torch.cuda.current_stream(dev).cuda_stream)
        count_launch("selective_scan_bwd", (b, s, di, n))
        check(status, "selective_scan_bwd")
    else:  # the kernel writes every element otherwise: these are sums over nothing
        for t in (dB, dC, dA_log, dD):
            t.zero_()
    return ddt, dB, dC, dx, dA_log, dD


def _check_scan_inputs(name: str, dt, Bm, Cm, x, A_log, D, *more) -> None:
    """The forward's inputs (and the backward's others, None allowed) on
    one CUDA device, with the dtypes and shapes the kernels take."""
    tensors = [t for t in (dt, Bm, Cm, x, A_log, D, *more) if t is not None]
    if any(t.device.type != "cuda" or t.device != dt.device for t in tensors):
        raise ValueError(f"{name}: expected every input on one CUDA device")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x {x.dtype} not in {list(_DTYPES)}")
    if any(t.dtype != torch.float32 for t in (dt, Bm, Cm, A_log, D)):
        raise ValueError(f"{name}: dt, B, C, A_log and D must be float32")
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"{name}: dt {tuple(dt.shape)} and x {tuple(x.shape)} "
                         "must both be (b, s, di)")
    b, s, di = dt.shape
    n = Bm.shape[-1]
    if Bm.shape != (b, s, n) or Cm.shape != (b, s, n) or A_log.shape != (di, n) \
            or D.shape != (di,):
        raise ValueError(f"{name}: B/C (b, s, n), A_log (di, n) or D (di,) mismatch")
    if not 1 <= n <= MAX_STATE or b > 65535 or max(s, di) >= 2 ** 31:
        raise ValueError(f"{name}: state size {n} not in 1..{MAX_STATE}, "
                         "batch above 65535 or a length above 2**31")
