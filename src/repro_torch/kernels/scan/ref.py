"""Plain PyTorch versions of the selective-scan kernels: the forward
(:func:`selective_scan_ref`), its backward (:func:`selective_scan_bwd_ref`)
and the kernels' decompositions (:func:`selective_scan_blocked`,
:func:`selective_scan_bwd_blocked`)."""
from __future__ import annotations

import math
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
# the backward kernel against selective_scan_bwd_ref, each gradient within
# this share of its max |g|: f32 gradients (the kernel's ex2.approx a_t and
# its sums over steps, states and channels in another order), and a bf16 dx
# (both round the f32 sum once; one bf16 step is 2^-8 of the value, 3.9e-3)
SCAN_BWD_TOL = 1e-4
SCAN_BWD_BF16_TOL = 1e-2


def selective_scan_blocked(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                           x: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                           out_dtype: Optional[torch.dtype] = None, *, items: int = 16,
                           segments: int = 4, return_chunk_states: bool = False):
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
    to f32 rounding, and with ``return_chunk_states`` also the state
    entering each chunk, (b, n_chunks, di, n), as the kernel writes it for
    the backward; nothing on the card's path calls it."""
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
    y = y.to(out_dtype or x.dtype)
    return (y, h, h_in) if return_chunk_states else (y, h)


def selective_scan_bwd_ref(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                           x: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                           dy: torch.Tensor, dh_last: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`selective_scan_ref` by its explicit adjoint,
    one step at a time in f32: with ``g_t = dL/dh_t = dy_t C_t + a_{t+1}
    g_{t+1}`` from ``g_s = dh_last`` (zero when None), returns (ddt, dB, dC,
    dx, dA_log, dD) with ``ddt_t = sum_n g_t (h_{t-1} a_t A + x_t B_t)``,
    ``dx_t = dt_t sum_n g_t B_t + D dy_t`` (in x's dtype), ``dB_t = sum_d
    g_t dt_t x_t``, ``dC_t = sum_d dy_t h_t``, ``dA_log = A sum_{b,t} g_t
    h_{t-1} a_t dt_t`` and ``dD = sum_{b,t} dy_t x_t``."""
    A = -torch.exp(A_log.float())
    dtf, xf, dyf = dt.float(), x.float(), dy.float()
    Bf, Cf = Bm.float(), Cm.float()
    b, s, di = dtf.shape
    n = A.shape[1]
    h = torch.zeros((b, di, n), dtype=torch.float32, device=dt.device)
    hs = [h]  # hs[t] = h_{t-1}, the state step t starts from
    for t in range(s):
        h = torch.exp(dtf[:, t, :, None] * A) * h + \
            (dtf[:, t] * xf[:, t])[:, :, None] * Bf[:, t, None, :]
        hs.append(h)
    r = (torch.zeros_like(h) if dh_last is None else dh_last.float())  # a_{t+1} g_{t+1}
    ddt, dx = torch.empty_like(dtf), torch.empty_like(xf)
    dB, dC = torch.empty_like(Bf), torch.empty_like(Cf)
    dA = torch.zeros_like(A)
    for t in reversed(range(s)):
        a = torch.exp(dtf[:, t, :, None] * A)
        g = dyf[:, t, :, None] * Cf[:, t, None, :] + r
        q = g * a * hs[t]
        gB = torch.einsum("bdn,bn->bd", g, Bf[:, t])
        ddt[:, t] = (q * A).sum(-1) + xf[:, t] * gB
        dx[:, t] = dtf[:, t] * gB + D.float() * dyf[:, t]
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dtf[:, t] * xf[:, t])
        dC[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dyf[:, t])
        dA += (q * dtf[:, t, :, None]).sum(0)
        r = a * g
    dD = (dyf * xf).sum((0, 1))
    return ddt, dB, dC, dx.to(x.dtype), dA * A, dD


def selective_scan_bwd_blocked(dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                               x: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                               h_chunks: torch.Tensor, dy: torch.Tensor,
                               dh_last: Optional[torch.Tensor] = None, *, items: int = 16,
                               segments: int = 4, block_channels: int = 64
                               ) -> Tuple[torch.Tensor, ...]:
    """The backward split as ``csrc/selective_scan_bwd.cu`` splits it, in
    plain PyTorch, from the forward's chunk states ``h_chunks`` (b,
    n_chunks, di, n) (``selective_scan_blocked(..., return_chunk_states=
    True)``): each segment of ``items`` steps recomputes h from the chunk's
    entering state and the forward's pair scan; with ``r_t = a_t g_t`` the
    adjoint step is the pair (a_t, a_t dy_t C_t), each segment's pair
    (``exp2(A log2 e sum dt)``, its serial sum) scanned over the chunk's
    segments in reverse and applied to the r carried back from the next
    chunk (seeded with dh_last; steps past s have a = 1, dy = 0); a serial
    pass from each segment's true r forms g and every term. dB and dC are
    summed over ``block_channels`` channels a block, then the blocks'
    partials added in block order; dA_log and dD over the batch rows last.
    Same results as :func:`selective_scan_bwd_ref` up to f32 rounding;
    nothing on the card's path calls it."""
    A2 = -torch.exp(A_log.float()) * LOG2E  # (di, n)
    dtf, xf, dyf = dt.float(), x.float(), dy.float()
    b, s, di = dtf.shape
    n = A2.shape[1]
    dev = dt.device
    chunk = segments * items
    pad = (-s) % chunk
    n_chunks = (s + pad) // chunk
    split = (b, n_chunks, segments, items)
    dtp, xp, dyp = (F.pad(t, (0, 0, 0, pad)).view(*split, di) for t in (dtf, xf, dyf))
    Bp, Cp = (F.pad(t.float(), (0, 0, 0, pad)).view(*split, n) for t in (Bm, Cm))
    # per step (b, chunk, segment, item, di, n)
    a = torch.exp2(dtp[..., None] * A2)
    bb = (dtp * xp)[..., None] * Bp[..., None, :]
    # 1. h: each segment's forward pair, the scan over the chunk's segments
    # (as selective_scan_blocked), the chunk's entering state, a serial pass
    pb = torch.zeros((b, n_chunks, segments, di, n), dtype=torch.float32, device=dev)
    for i in range(items):
        pb = a[:, :, :, i] * pb + bb[:, :, :, i]
    seg_a = torch.exp2(dtp.sum(3)[..., None] * A2)
    ia, ib = seg_a, pb
    step = 1
    while step < segments:
        na, nb = ia.clone(), ib.clone()
        na[:, :, step:] = ia[:, :, step:] * ia[:, :, :-step]
        nb[:, :, step:] = ia[:, :, step:] * ib[:, :, :-step] + ib[:, :, step:]
        ia, ib = na, nb
        step *= 2
    ea = torch.cat([torch.ones_like(ia[:, :, :1]), ia[:, :, :-1]], dim=2)
    eb = torch.cat([torch.zeros_like(ib[:, :, :1]), ib[:, :, :-1]], dim=2)
    h = ea * h_chunks.float()[:, :, None] + eb  # each segment's entering state
    hprev = []
    for i in range(items):
        hprev.append(h)
        h = a[:, :, :, i] * h + bb[:, :, :, i]
    hprev.append(h)
    # 2. the adjoint: each segment's reverse pair (r_first = seg_a r_in + rb)
    c = dyp[..., None] * Cp[..., None, :]
    rb = torch.zeros_like(pb)
    for i in reversed(range(items)):
        rb = a[:, :, :, i] * (c[:, :, :, i] + rb)
    # the reverse inclusive scan over the chunk's segments, then its
    # exclusive form (the segments after this one)
    ja, jb = seg_a, rb
    step = 1
    while step < segments:
        na, nb = ja.clone(), jb.clone()
        na[:, :, :-step] = ja[:, :, :-step] * ja[:, :, step:]
        nb[:, :, :-step] = ja[:, :, :-step] * jb[:, :, step:] + jb[:, :, :-step]
        ja, jb = na, nb
        step *= 2
    xa = torch.cat([ja[:, :, 1:], torch.ones_like(ja[:, :, :1])], dim=2)
    xb = torch.cat([jb[:, :, 1:], torch.zeros_like(jb[:, :, :1])], dim=2)
    # the r carried from chunk to chunk, last to first
    r = (torch.zeros((b, di, n), dtype=torch.float32, device=dev) if dh_last is None
         else dh_last.float())
    r_end = torch.empty((b, n_chunks, di, n), dtype=torch.float32, device=dev)
    for k in reversed(range(n_chunks)):
        r_end[:, k] = r
        r = ja[:, k, 0] * r + jb[:, k, 0]
    rr = xa * r_end[:, :, None] + xb  # r entering each segment from the right
    gB = torch.zeros_like(dtp)
    gAh = torch.zeros_like(dtp)
    dA = torch.zeros((b, n_chunks, segments, di, n), dtype=torch.float32, device=dev)
    dB_c = torch.empty((b, n_chunks, segments, items, di, n), dtype=torch.float32, device=dev)
    dC_c = torch.empty_like(dB_c)
    for i in reversed(range(items)):
        g = c[:, :, :, i] + rr
        qv = g * a[:, :, :, i] * hprev[i]
        gAh[:, :, :, i] = (qv * A2).sum(-1)
        dA = dA + qv * dtp[:, :, :, i, :, None]
        gB[:, :, :, i] = (g * Bp[:, :, :, i, None, :]).sum(-1)
        rr = a[:, :, :, i] * g
        dB_c[:, :, :, i] = g * (dtp * xp)[:, :, :, i, :, None]
        dC_c[:, :, :, i] = dyp[:, :, :, i, :, None] * hprev[i + 1]
    ddt = (math.log(2.0) * gAh + xp * gB).reshape(b, -1, di)[:, :s]
    dx = (dtp * gB + D.float() * dyp).reshape(b, -1, di)[:, :s]
    # 3. dB and dC: a partial a block of channels, then the blocks' partials
    # in block order
    n_blocks = -(-di // block_channels)
    cpad = n_blocks * block_channels - di
    dB, dC = (F.pad(t, (0, 0, 0, cpad)).reshape(b, -1, n_blocks, block_channels, n)
              .sum(3).reshape(b, -1, n_blocks, n)[:, :s] for t in (dB_c, dC_c))
    dB, dC = dB.sum(2), dC.sum(2)
    dA_log = -torch.exp(A_log.float()) * dA.sum((1, 2)).sum(0)
    dD = (dyf * xf).sum(1).sum(0)
    return ddt, dB, dC, dx.to(x.dtype), dA_log, dD
