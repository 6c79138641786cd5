"""Hopper quantize / dequantize kernels (``csrc/quant_pack.cu``).

Replace ``repro.kernels.codec.quant_pack.quantize_chunks`` and
``dequantize_chunks`` (Pallas), with the int4 nibble pack and unpack fused.
Both are bound by bytes; the source file states the bound and the design.
:func:`dequantize_group` decodes every leaf of a group (a gossip hop's
leaves, laid out by :class:`.group.GroupLayout`) in one launch. These
wrappers take CUDA tensors only: :mod:`.ops` dispatches; a fake tensor
takes the fake route (the outputs, no launch).

:func:`quantize_cost` and :func:`dequantize_cost` give one launch's
operations and bytes.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import Cost, count_launch, is_fake
from .._build import check, lib
from .group import MAX_GROUP_LEAVES, GroupLayout, group_layout


def quantize_cost(rows: int, size: int, bits: int, chunk: int) -> Optional[Cost]:
    """One launch on (rows, size) f32: x read, codes and scales written
    once; 5 operations an element (|x|, the max, the divide, the round, the
    clamp). None where the wrapper launches nothing."""
    n_chunks = -(-size // chunk)
    code_bytes = rows * n_chunks * (chunk if bits == 8 else chunk // 2)
    if not code_bytes:
        return None
    return Cost(5 * rows * size, 4 * rows * size + code_bytes + 4 * rows * n_chunks)


def dequantize_cost(layout: GroupLayout) -> Optional[Cost]:
    """One launch decoding a group: the codes and scales arenas read and
    every leaf's f32 output written once; one multiply an element."""
    if not layout.total_chunks:
        return None
    n = layout.rows * sum(layout.sizes)
    return Cost(n, layout.total_chunks * layout.width + 4 * layout.total_chunks + 4 * n)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.device.type != "cuda" and not is_fake(t):
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


def quantize_rows(flat: torch.Tensor, bits: int, chunk: int,
                  out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, size) f32 -> codes (rows, C, chunk) int8 or (rows, C, chunk // 2)
    uint8, scales (rows, C) f32; C = ceil(size / chunk), padding per row.
    ``out``: contiguous (codes, scales) to write, e.g. a leaf's arena slices."""
    _require_cuda(flat, torch.float32, "quantize")
    _check_chunk(chunk, bits)
    rows, size = flat.shape
    n_chunks = -(-size // chunk)
    width, dtype = (chunk, torch.int8) if bits == 8 else (chunk // 2, torch.uint8)
    if out is None:
        codes = torch.empty((rows, n_chunks, width), dtype=dtype, device=flat.device)
        scales = torch.empty((rows, n_chunks), dtype=torch.float32, device=flat.device)
    else:
        codes, scales = out
        _require_cuda(codes, dtype, "quantize")
        _require_cuda(scales, torch.float32, "quantize")
        if codes.shape != (rows, n_chunks, width) or scales.shape != (rows, n_chunks):
            raise ValueError(f"quantize: out {tuple(codes.shape)} / {tuple(scales.shape)} do "
                             f"not match ({rows}, {n_chunks}, {width})")
    if codes.numel() and not is_fake(flat):
        with torch.cuda.device(flat.device):
            status = lib().rt_quantize(flat.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                                       rows, size, n_chunks, chunk, bits, _stream(flat))
        count_launch("quantize", (rows, size, bits))
        check(status, "quantize")
    return codes, scales


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor, size: int,
                    bits: int, chunk: int) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: (rows, size) f32, as a group of one."""
    _check_chunk(chunk, bits)
    rows, n_chunks = scales.shape
    width = chunk if bits == 8 else chunk // 2
    if codes.shape != (rows, n_chunks, width) or n_chunks != -(-size // chunk):
        raise ValueError(f"dequantize: codes {tuple(codes.shape)} / scales "
                         f"{tuple(scales.shape)} do not match size={size}, chunk={chunk}")
    layout = group_layout(rows, (size,), bits, chunk)
    return dequantize_group(codes.view(-1, width), scales.view(-1), layout)[0]


def dequantize_group(codes: torch.Tensor, scales: torch.Tensor, layout: GroupLayout
                     ) -> List[torch.Tensor]:
    """Every leaf of a group in one launch: codes ``(total_chunks, w)`` and
    scales ``(total_chunks,)`` arenas in, each leaf's ``(rows, size_l)`` f32
    view of one output arena out."""
    _check_chunk(layout.chunk, layout.bits)
    _require_cuda(codes, torch.int8 if layout.bits == 8 else torch.uint8, "dequantize")
    _require_cuda(scales, torch.float32, "dequantize")
    if (codes.shape != (layout.total_chunks, layout.width)
            or scales.shape != (layout.total_chunks,)):
        raise ValueError(f"dequantize: codes {tuple(codes.shape)} / scales "
                         f"{tuple(scales.shape)} do not match the group's "
                         f"({layout.total_chunks}, {layout.width})")
    if layout.n_leaves > MAX_GROUP_LEAVES:
        raise ValueError(f"dequantize: {layout.n_leaves} leaves in a group, at most "
                         f"{MAX_GROUP_LEAVES}")
    out = torch.empty(layout.n_out, dtype=torch.float32, device=codes.device)
    if layout.total_chunks and not is_fake(codes):
        with torch.cuda.device(codes.device):
            if layout.n_leaves == 1:  # by value, no table; a large leaf: a CTA a chunk
                status = lib().rt_dequantize(
                    codes.data_ptr(), scales.data_ptr(), out.data_ptr(), layout.rows,
                    layout.sizes[0], layout.n_chunks[0], layout.chunk, layout.bits,
                    _stream(codes))
            else:
                status = lib().rt_dequantize_group(
                    codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
                    layout.table(codes.device).data_ptr(), layout.n_leaves,
                    layout.total_chunks, layout.chunk, layout.bits, _stream(codes))
        count_launch("dequantize", layout.key)
        check(status, "dequantize")
    return layout.outputs(out)
