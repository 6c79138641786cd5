"""Where each leaf of a group lies in the quantizer's arenas.

A gossip hop encodes every leaf of a group on its own (per-row chunking and
zero padding, the same codes and scales as the leaf alone) and decodes all
of them in one launch. The arenas are leaf-major: leaf ``l``'s codes
``(rows, C_l, w)``, scales ``(rows, C_l)`` and output ``(rows, size_l)``
are each one contiguous slice, the codes and scales from chunk
``chunk0[l]``, the output from element ``out0[l]``, a multiple of 4 (16
bytes), so each decoded leaf is a view of the output arena.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import torch

MAX_GROUP_LEAVES = 1024  # the decode kernel stages a group's table in shared memory


class GroupLayout:
    """The arenas of ``rows`` payloads of each of ``sizes`` elements."""

    def __init__(self, rows: int, sizes: Sequence[int], bits: int, chunk: int) -> None:
        self.rows, self.sizes, self.bits, self.chunk = rows, tuple(sizes), bits, chunk
        self.width = chunk if bits == 8 else chunk // 2  # code bytes a chunk
        self.n_chunks = tuple(-(-s // chunk) for s in self.sizes)
        self.chunk0, self.out0 = [0], [0]  # one entry past the last leaf
        for size, n in zip(self.sizes, self.n_chunks):
            self.chunk0.append(self.chunk0[-1] + rows * n)
            self.out0.append(self.out0[-1] + -(-rows * size // 4) * 4)
        self.total_chunks, self.n_out = self.chunk0[-1], self.out0[-1]
        self.key = (rows, self.sizes, bits)  # the dequantize launch's shape
        self._tables: Dict[str, torch.Tensor] = {}

    @property
    def n_leaves(self) -> int:
        return len(self.sizes)

    def table(self, device: torch.device) -> torch.Tensor:
        """(leaves, 4) int64 rows of (chunk0, out0, size, n_chunks), the
        kernel's ``struct Leaf``; built once a device."""
        key = str(device)
        if key not in self._tables:
            rows = [(self.chunk0[l], self.out0[l], s, n)
                    for l, (s, n) in enumerate(zip(self.sizes, self.n_chunks))]
            self._tables[key] = torch.tensor(rows, dtype=torch.int64, device=device)
        return self._tables[key]

    def arenas(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Empty codes ``(total_chunks, width)`` and scales ``(total_chunks,)``."""
        dtype = torch.int8 if self.bits == 8 else torch.uint8
        return (torch.empty((self.total_chunks, self.width), dtype=dtype, device=device),
                torch.empty(self.total_chunks, dtype=torch.float32, device=device))

    def codes(self, arena: torch.Tensor, l: int) -> torch.Tensor:
        return arena[self.chunk0[l]:self.chunk0[l + 1]].view(self.rows, self.n_chunks[l],
                                                              self.width)

    def scales(self, arena: torch.Tensor, l: int) -> torch.Tensor:
        return arena[self.chunk0[l]:self.chunk0[l + 1]].view(self.rows, self.n_chunks[l])

    def outputs(self, arena: torch.Tensor) -> List[torch.Tensor]:
        """Each leaf's ``(rows, size_l)`` view of the output arena."""
        return [arena[o:o + self.rows * s].view(self.rows, s)
                for o, s in zip(self.out0, self.sizes)]


@functools.lru_cache(maxsize=256)
def group_layout(rows: int, sizes: Tuple[int, ...], bits: int, chunk: int) -> GroupLayout:
    """The layout of a group, one object (and one device table) per key."""
    return GroupLayout(rows, sizes, bits, chunk)
