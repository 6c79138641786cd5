"""Plain PyTorch versions of the codec kernels.

``quantize_ref`` / ``dequantize_ref`` / ``topk_select_ref`` work on the
chunked layout, as ``repro.kernels.codec.ref`` does: ``x`` is ``(C, chunk)``
rows of consecutive flat elements. The ``*_rows`` functions are the plain
versions of the kernels' whole function at the wrapper's interface: ``rows``
payloads of ``size`` elements each, padded per row, with the int4 nibble
pack and unpack of ``repro.kernels.codec.ops``. They run on any device; the
CPU path of :mod:`.ops` and the on-card comparisons use them.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def quantize_ref(x: torch.Tensor, qmax: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric absmax quantization: (codes int8, scales f32)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not the IEEE divide the wire format needs
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, qmax),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale[:, None]), -qmax, qmax)
    return q.to(torch.int8), scale


def dequantize_ref(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return codes.float() * scales[:, None].float()


def topk_select_ref(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k by |value| (ties to the lower index): (values, idx),
    packed in ascending index order."""
    xf = x.float()
    order = torch.sort(xf.abs(), dim=1, descending=True, stable=True).indices[:, :k]
    idx = torch.sort(order, dim=1).values
    return torch.gather(xf, 1, idx), idx.to(torch.int32)


def chunked(flat: torch.Tensor, chunk: int) -> torch.Tensor:
    """(rows, size) -> (rows * C, chunk), each row zero-padded on its own."""
    rows, size = flat.shape
    pad = (-size) % chunk
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(rows * ((size + pad) // chunk), chunk)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes (..., chunk) -> uint8 (..., chunk // 2), even element low."""
    u = codes.to(torch.uint8)
    return (u[..., 0::2] & 0xF) | ((u[..., 1::2] & 0xF) << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (..., w) -> int8 (..., 2w), 4-bit two's complement extended."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo, hi = (torch.where(v >= 8, v - 16, v) for v in (lo, hi))
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def quantize_rows(flat: torch.Tensor, bits: int, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, size) f32 -> codes (rows, C, chunk) int8 or (rows, C, chunk // 2)
    uint8, scales (rows, C) f32."""
    rows = flat.shape[0]
    codes, scales = quantize_ref(chunked(flat, chunk), float(2 ** (bits - 1) - 1))
    if bits == 4:
        codes = pack_int4(codes)
    return codes.reshape(rows, -1, codes.shape[-1]), scales.reshape(rows, -1)


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor, size: int,
                    bits: int, chunk: int) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: (rows, size) f32."""
    rows = codes.shape[0]
    if bits == 4:
        codes = unpack_int4(codes)
    out = dequantize_ref(codes.reshape(-1, chunk), scales.reshape(-1))
    return out.reshape(rows, -1)[:, :size]


def topk_select_rows(flat: torch.Tensor, k: int, block: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, size) f32 -> values (rows, C, k) f32, indices (rows, C, k) i32."""
    rows = flat.shape[0]
    vals, idx = topk_select_ref(chunked(flat, block), k)
    return vals.reshape(rows, -1, k), idx.reshape(rows, -1, k)
