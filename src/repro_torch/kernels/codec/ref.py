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

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from .group import GroupLayout


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


def topk_select_threshold(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k kernel's threshold select, step for step, in PyTorch: the
    same function as :func:`topk_select_ref` (``block % 32 == 0``).

    Keys are the bits of |x|; lane ``l`` of the kernel's warp holds columns
    ``j * 32 + l``. T, the k-th largest key, lies between the smallest lane
    maximum (for k <= 32; else 0) and the largest key, and shares the bits
    above the highest one where those two differ. A bitwise search fixes the
    rest, stopping where exactly k keys lie at or above its candidate. Keys
    above T are taken, then the lowest-index keys equal to T.
    """
    xf = x.float().contiguous()
    c, block = xf.shape
    key = (xf.view(torch.int32) & 0x7FFFFFFF).long()
    lane_max = key.view(c, block // 32, 32).amax(dim=1)
    hi = lane_max.amax(dim=1)
    lb = lane_max.amin(dim=1) if k <= 32 else torch.zeros_like(hi)
    top = torch.full_like(hi, -1)  # the highest bit where lb and hi differ
    for bit in range(31):
        top = torch.where(((lb ^ hi) >> bit) & 1 == 1, bit, top)
    lo = torch.where(top < 0, hi, lb & ~((2 << top.clamp(min=0)) - 1))
    exact = torch.zeros_like(hi, dtype=torch.bool)
    for bit in range(30, -1, -1):
        cand = lo | (1 << bit)
        n = (key >= cand[:, None]).sum(dim=1)
        take = (bit <= top) & ~exact & (n >= k)
        lo = torch.where(take, cand, lo)
        exact |= take & (n == k)
    eq = key == lo[:, None]
    need = k - (key > lo[:, None]).sum(dim=1, keepdim=True)
    ties = (torch.cumsum(eq.long(), dim=1) - 1 < need) & eq
    sel = torch.where(exact[:, None], key >= lo[:, None], (key > lo[:, None]) | ties)
    idx = sel.nonzero()[:, 1].view(c, k)
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
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], 2 * packed.shape[-1])


def quantize_rows(flat: torch.Tensor, bits: int, chunk: int,
                  out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, size) f32 -> codes (rows, C, chunk) int8 or (rows, C, chunk // 2)
    uint8, scales (rows, C) f32; written into ``out`` where it is given."""
    rows = flat.shape[0]
    codes, scales = quantize_ref(chunked(flat, chunk), float(2 ** (bits - 1) - 1))
    if bits == 4:
        codes = pack_int4(codes)
    codes, scales = codes.reshape(rows, -1, codes.shape[-1]), scales.reshape(rows, -1)
    if out is None:
        return codes, scales
    out[0].copy_(codes)
    out[1].copy_(scales)
    return out


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor, size: int,
                    bits: int, chunk: int) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: (rows, size) f32."""
    rows, n_chunks = codes.shape[:2]
    if bits == 4:
        codes = unpack_int4(codes)
    out = dequantize_ref(codes.reshape(-1, chunk), scales.reshape(-1))
    return out.reshape(rows, n_chunks * chunk)[:, :size]


def dequantize_group(codes: torch.Tensor, scales: torch.Tensor, layout: GroupLayout
                     ) -> List[torch.Tensor]:
    """The grouped kernel's function: :func:`dequantize_rows` a leaf, into
    the layout's output arena; each leaf's ``(rows, size_l)`` view."""
    arena = torch.empty(layout.n_out, dtype=torch.float32, device=codes.device)
    outs = layout.outputs(arena)
    for l, (out, size) in enumerate(zip(outs, layout.sizes)):
        out.copy_(dequantize_rows(layout.codes(codes, l), layout.scales(scales, l), size,
                                  layout.bits, layout.chunk))
    return outs


def topk_select_rows(flat: torch.Tensor, k: int, block: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, size) f32 -> values (rows, C, k) f32, indices (rows, C, k) i32."""
    rows = flat.shape[0]
    vals, idx = topk_select_ref(chunked(flat, block), k)
    return vals.reshape(rows, -1, k), idx.reshape(rows, -1, k)
