"""Mamba1 (S6) block of the port (``repro.models.mamba``, Mamba1 only).

The full-sequence block runs its recurrence through the selective-scan op
(the Hopper kernel on the card, its plain version on the CPU) where the JAX
package runs ``chunked_selective_scan``; the scan returns y in f32 with
``D x`` added, and the block gates it with ``silu(z)`` before rounding to
the model dtype, as the JAX block does. The one-token decode step stays
plain PyTorch, as the JAX package's is. Projections are separate weights
(wx / wz / wB / wC / wdt_in), as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.scan.ops import selective_scan_op
from .layers import Params, dense_init


def init_mamba1(gen: torch.Generator, d_model: int, d_inner: int, d_state: int,
                dt_rank: int, conv_width: int, dtype: torch.dtype) -> Params:
    dev = gen.device
    return {
        "wx": dense_init(gen, (d_model, d_inner), dtype),
        "wz": dense_init(gen, (d_model, d_inner), dtype),
        "conv_w": dense_init(gen, (conv_width, d_inner), dtype, scale=0.5),
        "wdt_in": dense_init(gen, (d_inner, dt_rank), dtype),
        "wB": dense_init(gen, (d_inner, d_state), dtype),
        "wC": dense_init(gen, (d_inner, d_state), dtype),
        "dt_proj": dense_init(gen, (dt_rank, d_inner), dtype),
        "dt_bias": torch.zeros((d_inner,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.arange(1, d_state + 1, dtype=torch.float32, device=dev)
                           ).expand(d_inner, d_state).contiguous(),
        "D": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (d_inner, d_model), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, cache: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along seq. x (b, s, di); w (width, di); cache
    (b, width-1, di) holds the previous inputs. Returns (out, new cache)."""
    width = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (b, s + width - 1, di)
    s = x.shape[1]
    out = 0
    for i in range(width):
        out = out + xp[:, i:i + s, :] * w[i]
    return out, xp[:, xp.shape[1] - (width - 1):, :]


def _mamba1_ssm_inputs(params: Params, xc: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dt (b, s, di), B and C (b, s, n), all f32, from the post-conv
    activations xc (b, s, di)."""
    dt_low = (xc @ params["wdt_in"]).float()
    dt = F.softplus(dt_low @ params["dt_proj"].float() + params["dt_bias"])
    Bm = (xc @ params["wB"]).float()
    Cm = (xc @ params["wC"]).float()
    return dt, Bm, Cm


def mamba1_forward(params: Params, x: torch.Tensor, d_state: int, dt_rank: int) -> torch.Tensor:
    """Full-sequence Mamba1 block. x: (b, s, d_model)."""
    xi = x @ params["wx"]
    z = x @ params["wz"]
    xc, _ = _causal_conv(xi, params["conv_w"])
    xc = F.silu(xc)
    dt, Bm, Cm = _mamba1_ssm_inputs(params, xc)
    y, _ = selective_scan_op(dt, Bm, Cm, xc, params["A_log"], params["D"],
                             out_dtype=torch.float32)
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ params["out_proj"]


def init_mamba1_cache(batch: int, d_inner: int, d_state: int, conv_width: int,
                      dtype: torch.dtype, device=None) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, conv_width - 1, d_inner), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, d_inner, d_state), dtype=torch.float32, device=device),
    }


def mamba1_decode(params: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                  d_state: int, dt_rank: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step. x: (b, 1, d_model); returns (out, new cache)."""
    xi = x @ params["wx"]
    z = x @ params["wz"]
    xc, new_conv = _causal_conv(xi, params["conv_w"], cache["conv"])
    xc = F.silu(xc)
    dt, Bm, Cm = _mamba1_ssm_inputs(params, xc)
    A = -torch.exp(params["A_log"])  # (di, n)
    dA = torch.exp(dt[:, 0, :, None] * A)  # (b, di, n)
    dBx = (dt[:, 0] * xc[:, 0].float())[:, :, None] * Bm[:, 0, None, :]
    h = dA * cache["ssm"] + dBx
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None, :]
    y = y + params["D"] * xc.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ params["out_proj"], {"conv": new_conv.to(cache["conv"].dtype), "ssm": h}
