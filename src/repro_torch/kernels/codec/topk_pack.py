"""Hopper block-local top-k select + pack kernel (``csrc/topk_pack.cu``).

Replaces ``repro.kernels.codec.topk_pack.topk_select_blocks`` (Pallas): per
``block`` consecutive elements, the ``k`` of largest magnitude (ties to the
lower index), packed in ascending index order. Bound by bytes; the source
file states the bound and the design. CUDA tensors only: :mod:`.ops`
dispatches; a fake tensor takes the fake route (the outputs, no launch).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import Cost, count_launch, is_fake
from .._build import check, lib
from .quant_pack import _require_cuda, _stream


def topk_cost(rows: int, size: int, block: int, k: int) -> Optional[Cost]:
    """One launch on (rows, size) f32: x read, k values and indices a block
    written once; k compare-selects an element of a block. None where the
    wrapper launches nothing."""
    n_blocks = -(-size // block)
    if not rows * n_blocks * k:
        return None
    return Cost(k * n_blocks * rows * block, 4 * rows * size + 8 * rows * n_blocks * k)


def topk_select_rows(flat: torch.Tensor, k: int, block: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, size) f32 -> values (rows, C, k) f32, indices (rows, C, k) i32;
    C = ceil(size / block), padding per row."""
    _require_cuda(flat, torch.float32, "topk_select")
    if block <= 0 or block % 32 or block > 1024:
        raise ValueError(f"the top-k kernel needs a block that is a multiple of 32 "
                         f"and at most 1024, got {block}")
    if not (1 <= k <= block):
        raise ValueError(f"need 1 <= k <= block, got k={k}, block={block}")
    rows, size = flat.shape
    n_blocks = -(-size // block)
    vals = torch.empty((rows, n_blocks, k), dtype=torch.float32, device=flat.device)
    idx = torch.empty((rows, n_blocks, k), dtype=torch.int32, device=flat.device)
    if vals.numel() and not is_fake(flat):
        with torch.cuda.device(flat.device):
            status = lib().rt_topk_select(flat.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                                          rows, size, n_blocks, block, k, _stream(flat))
        count_launch("topk_select", (rows, size, block, k))
        check(status, "topk_select")
    return vals, idx
