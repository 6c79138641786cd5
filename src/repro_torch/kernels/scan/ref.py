"""Plain PyTorch version of the selective-scan kernel."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def selective_scan_ref(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                       x: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x (b, s, di); Bm, Cm (b, s, n); A_log (di, n); D (di,).

    ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t`` and ``y_t = h_t . C_t +
    D x_t`` with ``A = -exp(A_log)``, in f32 from ``h_0 = 0``, one step at a
    time. Returns y (b, s, di) in ``out_dtype`` (x's dtype by default) and
    the last state (b, di, n) in f32."""
    A = -torch.exp(A_log.float())
    dtf, xf = dt.float(), x.float()
    Bf, Cf = Bm.float(), Cm.float()
    b, s, di = dtf.shape
    h = torch.zeros((b, di, A.shape[1]), dtype=torch.float32, device=dt.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dtf[:, t, :, None] * A)
        dBx = (dtf[:, t] * xf[:, t])[:, :, None] * Bf[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(xf)
    y = y + D.float() * xf
    return y.to(out_dtype or x.dtype), h


LOG2E = 1.4426950408889634


def selective_scan_blocked(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                           x: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                           out_dtype: Optional[torch.dtype] = None, *, items: int = 16,
                           segments: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan split as ``csrc/selective_scan.cu`` splits it, in
    plain PyTorch: the sequence in chunks of ``segments * items`` steps (a
    warp's lanes); each thread's segment of ``items`` steps scanned serially
    from a zero state into a pair (pa, pb) with ``h_end = pa h_start + pb``
    (pa as ``exp2(A log2 e sum dt)``); the pairs combined by an inclusive scan
    over the chunk's segments (steps 1, 2, .. as the kernel's shuffles) and
    its exclusive form, applied to the state carried out of the previous
    chunk; then each segment run again from its true entering state to form
    ``y_t = h_t . C_t + D x_t``. Steps past s run as a = 1, b = 0. Same
    arguments and results as :func:`selective_scan_ref`, which it equals up
    to f32 rounding; nothing on the card's path calls it."""
    A2 = -torch.exp(A_log.float()) * LOG2E  # (di, n)
    dtf, xf = dt.float(), x.float()
    b, s, di = dtf.shape
    n = A2.shape[1]
    chunk = segments * items
    pad = (-s) % chunk
    dtf, dtx = (F.pad(t, (0, 0, 0, pad)) for t in (dtf, dtf * xf))
    Bf, Cf = (F.pad(t.float(), (0, 0, 0, pad)) for t in (Bm, Cm))
    n_chunks = (s + pad) // chunk
    split = (b, n_chunks, segments, items)
    dtf, dtx = dtf.view(*split, di), dtx.view(*split, di)
    Bf, Cf = Bf.view(*split, n), Cf.view(*split, n)
    # per step (b, chunk, segment, item, di, n)
    a = torch.exp2(dtf[..., None] * A2)
    bb = dtx[..., None] * Bf[..., None, :]
    pb = torch.zeros((b, n_chunks, segments, di, n), dtype=torch.float32, device=dt.device)
    for i in range(items):  # the serial pass of each segment
        pb = a[:, :, :, i] * pb + bb[:, :, :, i]
    pa = torch.exp2(dtf.sum(3)[..., None] * A2)
    # the inclusive scan over a chunk's segments, then its exclusive form
    ia, ib = pa, pb
    step = 1
    while step < segments:
        na, nb = ia.clone(), ib.clone()
        na[:, :, step:] = ia[:, :, step:] * ia[:, :, :-step]
        nb[:, :, step:] = ia[:, :, step:] * ib[:, :, :-step] + ib[:, :, step:]
        ia, ib = na, nb
        step *= 2
    ea = torch.cat([torch.ones_like(ia[:, :, :1]), ia[:, :, :-1]], dim=2)
    eb = torch.cat([torch.zeros_like(ib[:, :, :1]), ib[:, :, :-1]], dim=2)
    # the state carried from chunk to chunk
    h = torch.zeros((b, di, n), dtype=torch.float32, device=dt.device)
    h_in = torch.empty((b, n_chunks, di, n), dtype=torch.float32, device=dt.device)
    for c in range(n_chunks):
        h_in[:, c] = h
        h = ia[:, c, -1] * h + ib[:, c, -1]
    # each segment again from its entering state
    hs = ea * h_in[:, :, None] + eb
    ys = []
    for i in range(items):
        hs = a[:, :, :, i] * hs + bb[:, :, :, i]
        ys.append((hs * Cf[:, :, :, i, None, :]).sum(-1))
    y = torch.stack(ys, dim=3).reshape(b, n_chunks * chunk, di)[:, :s]
    y = y + D.float() * xf
    return y.to(out_dtype or x.dtype), h
