"""Hopper block-local top-k select + pack kernel (``csrc/topk_pack.cu``).

Replaces ``repro.kernels.codec.topk_pack.topk_select_blocks`` (Pallas): per
``block`` consecutive elements, the ``k`` of largest magnitude (ties to the
lower index), packed in ascending index order. Bound by bytes; the source
file states the bound and the design. CUDA tensors only: :mod:`.ops`
dispatches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import count_launch
from .._build import check, lib
from .quant_pack import _require_cuda, _stream


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
    if vals.numel():
        with torch.cuda.device(flat.device):
            status = lib().rt_topk_select(flat.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                                          rows, size, n_blocks, block, k, _stream(flat))
        count_launch("topk_select", (rows, size, block, k))
        check(status, "topk_select")
    return vals, idx
