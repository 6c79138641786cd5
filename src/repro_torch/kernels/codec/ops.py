"""Public codec ops: flatten each row, then the kernel or its plain version.

Counterparts of ``repro.kernels.codec.ops``. Every op takes a tensor whose
leading axis is the row (node) axis: row ``i`` is one payload, flattened and
padded on its own, so one launch encodes every sending node's row. A CUDA
tensor goes to the Hopper kernel (or raises); a CPU tensor to the plain
version in :mod:`.ref` (a fake tensor: the kernel's fake route). There is
no fallback between the two. Each call is one
:class:`~repro_torch.kernels.kernel_call`.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import kernel_call, on_card
from . import ref
from .group import GroupLayout, group_layout
from .quant_pack import (dequantize_cost, dequantize_group, dequantize_rows, quantize_cost,
                         quantize_rows)
from .topk_pack import topk_cost, topk_select_rows


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(rows, ...) -> contiguous (rows, size) f32."""
    return x.reshape(x.shape[0], -1).float().contiguous()


def _on_card(t: torch.Tensor) -> bool:
    return on_card(t, "a codec op")


def _leaf_cost(rows: int, size: int, bits: int, chunk: int):
    """The cost of decoding one leaf: a group of one."""
    return dequantize_cost(group_layout(rows, (size,), bits, chunk))


def quantize_op(x: torch.Tensor, *, bits: int = 8, chunk: int = 1024,
                out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize each row into wire buffers: codes int8 ``(rows, C, chunk)``
    (8-bit) or nibble-packed uint8 ``(rows, C, chunk // 2)`` (4-bit), and f32
    scales ``(rows, C)``; into ``out`` (a leaf's arena slices) where given."""
    flat = _rows(x)
    with kernel_call("quantize", quantize_cost, *flat.shape, bits, chunk):
        if _on_card(flat):
            return quantize_rows(flat, bits, chunk, out=out)
        return ref.quantize_rows(flat, bits, chunk, out=out)


def dequantize_op(codes: torch.Tensor, scales: torch.Tensor, *, size: int,
                  bits: int = 8, chunk: int = 1024) -> torch.Tensor:
    """Inverse of :func:`quantize_op`: f32 ``(rows, size)``."""
    with kernel_call("dequantize", _leaf_cost, scales.shape[0], size, bits, chunk):
        if _on_card(codes):
            return dequantize_rows(codes, scales, size, bits, chunk)
        return ref.dequantize_rows(codes, scales, size, bits, chunk)


def dequantize_group_op(codes: torch.Tensor, scales: torch.Tensor, layout: GroupLayout
                        ) -> List[torch.Tensor]:
    """Every leaf of a group from its arenas (:class:`.group.GroupLayout`):
    each leaf's f32 ``(rows, size_l)``, views of one output arena. On the
    card, one launch for the group."""
    with kernel_call("dequantize", dequantize_cost, layout):
        if _on_card(codes):
            return dequantize_group(codes, scales, layout)
        return ref.dequantize_group(codes, scales, layout)


def topk_select_op(x: torch.Tensor, *, k: int, block: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-local top-k of each row: values f32 and indices i32, both
    ``(rows, C, k)``."""
    flat = _rows(x)
    with kernel_call("topk_select", topk_cost, *flat.shape, block, k):
        if _on_card(flat):
            return topk_select_rows(flat, k, block)
        return ref.topk_select_rows(flat, k, block)


def topk_scatter(vals: torch.Tensor, idx: torch.Tensor, *, size: int,
                 block: int) -> torch.Tensor:
    """Decode packed (values, indices) back to dense f32 ``(rows, size)``
    (a plain scatter, as the JAX package's jnp scatter outside Pallas)."""
    rows, n_blocks, _ = vals.shape
    dense = torch.zeros((rows, n_blocks, block), dtype=torch.float32, device=vals.device)
    dense.scatter_(2, idx.long(), vals.float())
    return dense.reshape(rows, -1)[:, :size]
