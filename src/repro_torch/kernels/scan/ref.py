"""Plain PyTorch version of the selective-scan kernel."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


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
