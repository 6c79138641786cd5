"""Plain reference of the Mamba1 stack as the port states it (falcon-mamba-7b).

Per layer ``x += mixer(rms(x))`` with the mixer

    xi = h wx,  z = h wz,  xc = silu(causal depthwise conv_w * xi)
    dt = softplus((xc wdt_in) dt_proj + dt_bias),  B = xc wB,  C = xc wC
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,  A = -exp(A_log),  h_{-1} = 0
    y_t = h_t . C_t + D x_t,  out = (y * silu(z)) out_proj

then a final RMS norm and the tied head (``dense.py``). The conv has no
bias and B, C and dt are not normalised: the port states the block so
(PERF.md lists both as departures from FalconMamba). The recurrence runs as
one fused multiply-add a step, forward and backward
(:class:`LinearRecurrence`), over tensors laid out time-major.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from .dense import cross_entropy, layer, rms_norm
from .numerics import MatMul


class LinearRecurrence(torch.autograd.Function):
    """``h_t = a_t * h_{t-1} + u_t`` from ``h_{-1} = 0`` over the first
    axis of (s, ...) tensors; returns every ``h_t``."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        a, u = a.contiguous(), u.contiguous()
        h = torch.empty_like(u)
        h[0] = u[0]
        for t in range(1, u.shape[0]):
            torch.addcmul(u[t], a[t], h[t - 1], out=h[t])
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, gh: torch.Tensor):
        a, h = ctx.saved_tensors
        gh = gh.contiguous()
        gu = torch.empty_like(gh)
        s = gh.shape[0]
        gu[s - 1] = gh[s - 1]
        for t in range(s - 2, -1, -1):
            torch.addcmul(gh[t], a[t + 1], gu[t + 1], out=gu[t])
        ga = torch.zeros_like(a)
        ga[1:] = gu[1:] * h[:-1]
        return ga, gu


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (b, s, di), w (width, di): out_t = sum_i w_i x_{t + i - width + 1}."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    return sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(width))


def mixer(p: Dict[str, torch.Tensor], h: torch.Tensor, mm: MatMul) -> torch.Tensor:
    xi, z = mm(h, p["wx"]), mm(h, p["wz"])
    xc = F.silu(causal_conv(xi, p["conv_w"]))
    dt = F.softplus(mm(mm(xc, p["wdt_in"]), p["dt_proj"]) + p["dt_bias"])
    Bm, Cm = mm(xc, p["wB"]), mm(xc, p["wC"])
    A = -torch.exp(p["A_log"])  # (di, n)
    # time-major (s, b, di, n)
    dA = torch.exp(dt.transpose(0, 1)[..., None] * A)
    u = (dt * xc).transpose(0, 1)[..., None] * Bm.transpose(0, 1)[:, :, None, :]
    hs = LinearRecurrence.apply(dA, u)
    y = torch.einsum("sbdn,sbn->bsd", hs, Cm.transpose(0, 1)) + p["D"] * xc
    return mm(y * F.silu(z), p["out_proj"])


def loss(params: Dict[str, Any], hf: Dict[str, Any], tokens: torch.Tensor,
         labels: torch.Tensor, mm: MatMul) -> torch.Tensor:
    eps = hf["rms_norm_eps"]
    table = params["embed"]["table"]
    x = table[tokens]
    for i in range(hf["num_hidden_layers"]):
        blk = layer(params["blocks"], i)
        x = x + mixer(blk["body"], rms_norm(x, blk["ln"], eps), mm)
    x = rms_norm(x, params["final_norm"], eps)
    return cross_entropy(mm(x, table[:hf["vocab_size"]].t()), labels)
