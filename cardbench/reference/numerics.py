"""The reference's matrix products: float32 with TF32 off, or the control's
fp8.

The control is the reference computed a precision below what the
configurations state (bf16 parameters and activations): every projection's
operands in fp8 e4m3 with one scale a tensor (its absmax over 448), the
backward's incoming gradient in e5m2 (absmax over 57344), products summed in
float32. That is the step a later change might take to run the GEMMs on
Hopper's fp8 tensor cores; the benchmark's comparison must refuse it.
"""
from __future__ import annotations

from typing import Callable

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0

MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def fp32_strict() -> None:
    """Float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def plain_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _q(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded through ``dtype`` under one absmax scale, back in f32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (x.float() * scale).to(dtype).float() / scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        qa, qb = _q(a, torch.float8_e4m3fn, E4M3_MAX), _q(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        qa, qb = ctx.saved_tensors
        qg = _q(g, torch.float8_e5m2, E5M2_MAX)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(-1, qg.shape[-1])
        return ga, gb.reshape(qb.shape)


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for a (..., k) activation and a (k, n) weight, in fp8."""
    return _Fp8MatMul.apply(a, b)


MATMULS = {"fp32": plain_mm, "fp8": fp8_mm}
