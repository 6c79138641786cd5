"""Hopper quantize / dequantize kernels (``csrc/quant_pack.cu``).

Replace ``repro.kernels.codec.quant_pack.quantize_chunks`` and
``dequantize_chunks`` (Pallas), with the int4 nibble pack and unpack fused.
Both are bound by bytes; the source file states the bound and the design.
These wrappers take CUDA tensors only: :mod:`.ops` dispatches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import count_launch
from .._build import check, lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_chunk(chunk: int, bits: int) -> None:
    if chunk <= 0 or chunk % 4:
        raise ValueError(f"the quantize kernel needs chunk % 4 == 0, got {chunk}")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")


def quantize_rows(flat: torch.Tensor, bits: int, chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, size) f32 -> codes (rows, C, chunk) int8 or (rows, C, chunk // 2)
    uint8, scales (rows, C) f32; C = ceil(size / chunk), padding per row."""
    _require_cuda(flat, torch.float32, "quantize")
    _check_chunk(chunk, bits)
    rows, size = flat.shape
    n_chunks = -(-size // chunk)
    width, dtype = (chunk, torch.int8) if bits == 8 else (chunk // 2, torch.uint8)
    codes = torch.empty((rows, n_chunks, width), dtype=dtype, device=flat.device)
    scales = torch.empty((rows, n_chunks), dtype=torch.float32, device=flat.device)
    if codes.numel():
        with torch.cuda.device(flat.device):
            status = lib().rt_quantize(flat.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                                       rows, size, n_chunks, chunk, bits, _stream(flat))
        count_launch("quantize", (rows, size, bits))
        check(status, "quantize")
    return codes, scales


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor, size: int,
                    bits: int, chunk: int) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: (rows, size) f32."""
    _check_chunk(chunk, bits)
    _require_cuda(codes, torch.int8 if bits == 8 else torch.uint8, "dequantize")
    _require_cuda(scales, torch.float32, "dequantize")
    rows, n_chunks = scales.shape
    width = chunk if bits == 8 else chunk // 2
    if codes.shape != (rows, n_chunks, width) or n_chunks != -(-size // chunk):
        raise ValueError(f"dequantize: codes {tuple(codes.shape)} / scales "
                         f"{tuple(scales.shape)} do not match size={size}, chunk={chunk}")
    out = torch.empty((rows, size), dtype=torch.float32, device=codes.device)
    if out.numel():
        with torch.cuda.device(codes.device):
            status = lib().rt_dequantize(codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
                                         rows, size, n_chunks, chunk, bits, _stream(codes))
        count_launch("dequantize", (rows, size, bits))
        check(status, "dequantize")
    return out
