"""Payload codecs: the exact wire-byte model and the device encode/decode.

The wire model (:meth:`Codec.wire_bytes`, :meth:`Codec.mean_atol`,
:func:`per_send_wire_bytes`, :func:`per_send_wire_mb`) is a copy of
``repro.compress.codec``, so byte accounting agrees with the JAX package to
the bit. The device side replaces the JAX hooks: :meth:`Codec.encode` turns
a tensor into the buffers that cross the wire, :meth:`Codec.decode` turns
them back, :meth:`Codec.roundtrip` is both.

Every device method takes a tensor with a leading row axis: row ``i`` is one
payload (one node's leaf), flattened and padded on its own, so one launch
encodes every sending node's row and the wire buffers of a row equal those
of the same payload encoded alone.

==========  =================================================================
``fp32``    :class:`IdentityCodec` — raw float32, 4 bytes/element
``bf16``    :class:`Bf16Codec` — round-to-nearest-even bfloat16, 2 B/el
``int8``    :class:`UniformQuantCodec(bits=8)` — per-chunk absmax scales
``int4``    :class:`UniformQuantCodec(bits=4)` — two codes per byte
``topk``    :class:`TopKCodec` — block-local top-k (value, index) pairs
==========  =================================================================
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from ..kernels.codec.group import MAX_GROUP_LEAVES, group_layout
from ..kernels.codec.ops import (dequantize_group_op, dequantize_op, quantize_op,
                                 topk_scatter, topk_select_op)

Wire = Tuple[torch.Tensor, ...]


class Codec:
    """Payload codec: exact wire bytes, error bound, device encode/decode."""

    name: str = "abstract"
    lossless: bool = False
    error_feedback: bool = False  # the trainer carries a residual for it (sparsifiers)
    grouped: bool = False  # roundtrip_group decodes several leaves at once

    def wire_bytes(self, n_elements: int) -> int:
        """Exact bytes on the wire for ``n_elements`` float32 values."""
        raise NotImplementedError

    def mean_atol(self, max_abs: float) -> Optional[float]:
        """Worst-case per-element error of one encode at input magnitude
        ``max_abs``; ``None`` = no deterministic bound (sparsifiers)."""
        return 0.0 if self.lossless else None

    # -- device side ------------------------------------------------------------
    def encode(self, t: torch.Tensor) -> Wire:
        """Encode each row of ``t`` (shape ``(rows, *payload)``) into the
        wire buffers, each with the same leading row axis."""
        return (t,)

    def decode(self, enc: Wire, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
        """Inverse of :meth:`encode`: ``(rows, *shape)`` in ``dtype``."""
        return enc[0]

    def roundtrip(self, t: torch.Tensor) -> torch.Tensor:
        """decode(encode(t)) — what one hop does to the values."""
        return self.decode(self.encode(t), t.shape[1:], t.dtype)

    def roundtrip_group(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """:meth:`roundtrip` of each of ``ts`` (one hop's leaves, the same
        rows each); one decode for all where :attr:`grouped`."""
        return [self.roundtrip(t) for t in ts]

    # -- a group's wire between ranks -----------------------------------------------
    def wire_shapes(self, shape: Sequence[int]) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        """The (shape, dtype) of each buffer :meth:`encode` makes of a
        ``(rows, *payload)`` tensor of f32."""
        return [(tuple(shape), torch.float32)]

    def encode_group(self, ts: Sequence[torch.Tensor]) -> Wire:
        """The buffers that cross the wire for one hop's leaves ``ts`` (the
        same rows each): each leaf's :meth:`encode`, in leaf order."""
        return tuple(b for t in ts for b in self.encode(t))

    def empty_group(self, ts: Sequence[torch.Tensor]) -> Wire:
        """Zero-filled receive buffers for :meth:`encode_group` of leaves
        shaped and placed as ``ts``."""
        return tuple(torch.zeros(shape, dtype=dtype, device=t.device)
                     for t in ts for shape, dtype in self.wire_shapes(t.shape))

    def decode_group(self, enc: Wire, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Inverse of :meth:`encode_group`: each leaf in the shape and dtype
        of its entry of ``ts``."""
        out, i = [], 0
        for t in ts:
            n = len(self.wire_shapes(t.shape))
            out.append(self.decode(enc[i:i + n], t.shape[1:], t.dtype))
            i += n
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"{type(self).__name__}({self.name!r})"


def _numel(shape: Sequence[int]) -> int:
    return int(math.prod(shape))


class IdentityCodec(Codec):
    """Raw float32 on the wire — the paper's measurement baseline."""

    name = "fp32"
    lossless = True

    def wire_bytes(self, n_elements: int) -> int:
        return 4 * n_elements

    def roundtrip(self, t: torch.Tensor) -> torch.Tensor:
        return t


class Bf16Codec(Codec):
    """bfloat16 on the wire (round to nearest even), ≤ 2^-8 relative error."""

    name = "bf16"

    def wire_bytes(self, n_elements: int) -> int:
        return 2 * n_elements

    def mean_atol(self, max_abs: float) -> Optional[float]:
        return max_abs * 2.0 ** -8

    def wire_shapes(self, shape: Sequence[int]) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        return [(tuple(shape), torch.bfloat16)]

    def encode(self, t: torch.Tensor) -> Wire:
        return (t.to(torch.bfloat16),)

    def decode(self, enc: Wire, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
        return enc[0].to(dtype)


class UniformQuantCodec(Codec):
    """Symmetric uniform quantization, one float32 absmax scale per ``chunk``.

    ``q = clip(round(x / scale), -qmax, qmax)`` with ``scale = absmax / qmax``
    per chunk; int4 packs two codes per byte. Requantizing a decoded payload
    is exact, so multi-hop gossip pays the quantization error once.
    """

    grouped = True

    def __init__(self, bits: int = 8, chunk: int = 1024) -> None:
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if bits == 4 and chunk % 2:
            raise ValueError("int4 packs two codes per byte: chunk must be even")
        self.bits = bits
        self.chunk = chunk
        self.qmax = 2 ** (bits - 1) - 1
        self.name = f"int{bits}"

    def wire_bytes(self, n_elements: int) -> int:
        n_chunks = -(-n_elements // self.chunk)
        code_bytes = -(-n_elements * self.bits // 8)
        return code_bytes + 4 * n_chunks  # one f32 scale per chunk

    def mean_atol(self, max_abs: float) -> Optional[float]:
        # round() error ≤ scale/2 ≤ max_abs / (2 qmax); one ulp of slack for
        # the f32 divides
        return max_abs / (2 * self.qmax) * 1.01 + 1e-7

    def encode(self, t: torch.Tensor) -> Wire:
        return quantize_op(t, bits=self.bits, chunk=self.chunk)

    def decode(self, enc: Wire, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
        codes, scales = enc
        out = dequantize_op(codes, scales, size=_numel(shape), bits=self.bits,
                            chunk=self.chunk)
        return out.reshape(codes.shape[0], *shape).to(dtype)

    def roundtrip_group(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Each leaf quantized on its own into the group's arenas, then one
        decode for all of them (one each ``MAX_GROUP_LEAVES``, the decode
        kernel's table); the same values as :meth:`roundtrip` a leaf."""
        if len(ts) > MAX_GROUP_LEAVES:
            return [out for i in range(0, len(ts), MAX_GROUP_LEAVES)
                    for out in self.roundtrip_group(ts[i:i + MAX_GROUP_LEAVES])]
        return self.decode_group(self.encode_group(ts), ts)

    def _layout(self, ts: Sequence[torch.Tensor]):
        rows = ts[0].shape[0]
        if any(t.shape[0] != rows for t in ts):
            raise ValueError("a group's leaves differ in their row counts")
        if len(ts) > MAX_GROUP_LEAVES:
            raise ValueError(f"a group holds at most {MAX_GROUP_LEAVES} leaves")
        return group_layout(rows, tuple(_numel(t.shape[1:]) for t in ts), self.bits,
                            self.chunk)

    def encode_group(self, ts: Sequence[torch.Tensor]) -> Wire:
        """The group's two arenas, codes and scales, each leaf quantized on
        its own into its slices."""
        layout = self._layout(ts)
        codes, scales = layout.arenas(ts[0].device)
        for l, t in enumerate(ts):
            quantize_op(t, bits=self.bits, chunk=self.chunk,
                        out=(layout.codes(codes, l), layout.scales(scales, l)))
        return codes, scales

    def empty_group(self, ts: Sequence[torch.Tensor]) -> Wire:
        return tuple(torch.zeros_like(a) for a in self._layout(ts).arenas(ts[0].device))

    def decode_group(self, enc: Wire, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every leaf of the group in one decode."""
        outs = dequantize_group_op(enc[0], enc[1], self._layout(ts))
        return [o.reshape(t.shape).to(t.dtype) for o, t in zip(outs, ts)]


class TopKCodec(Codec):
    """Keep the top ``k = max(1, round(fraction·block))`` entries by
    magnitude of every ``block`` consecutive values, sent as (f32 value,
    i32 index) pairs. Re-encoding a decoded payload is exact."""

    error_feedback = True

    def __init__(self, fraction: float = 0.05, block: int = 256) -> None:
        if not (0.0 < fraction <= 1.0):
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        if block < 1:
            raise ValueError("block must be >= 1")
        self.fraction = fraction
        self.block = block
        self.k = max(1, int(round(fraction * block)))
        self.name = "topk"

    def wire_bytes(self, n_elements: int) -> int:
        n_blocks = -(-n_elements // self.block)
        return 8 * self.k * n_blocks

    def wire_shapes(self, shape: Sequence[int]) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        blocks = -(-_numel(shape[1:]) // self.block)
        return [((shape[0], blocks, self.k), torch.float32),
                ((shape[0], blocks, self.k), torch.int32)]

    def encode(self, t: torch.Tensor) -> Wire:
        return topk_select_op(t, k=self.k, block=self.block)

    def decode(self, enc: Wire, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
        vals, idx = enc
        out = topk_scatter(vals, idx, size=_numel(shape), block=self.block)
        return out.reshape(vals.shape[0], *shape).to(dtype)


CODEC_NAMES = ("fp32", "bf16", "int8", "int4", "topk")


def make_codec(name: Optional[str], **kwargs) -> Codec:
    """Build a codec by wire-format name (``None``/"" = fp32 identity)."""
    if name is None or name in ("", "fp32", "identity", "none"):
        return IdentityCodec()
    if name == "bf16":
        return Bf16Codec()
    if name == "int8":
        return UniformQuantCodec(bits=8, **kwargs)
    if name == "int4":
        return UniformQuantCodec(bits=4, **kwargs)
    if name == "topk":
        return TopKCodec(**kwargs)
    raise ValueError(f"unknown codec {name!r}; known: {CODEC_NAMES}")


def per_send_wire_bytes(codec: Optional[Codec], raw_bytes: float) -> float:
    """Wire bytes of one send carrying ``raw_bytes`` of fp32 payload."""
    if codec is None:
        return raw_bytes
    return codec.wire_bytes(int(round(raw_bytes / 4)))


def per_send_wire_mb(codec: Optional[Codec], payload_mb: float,
                     payload_fraction: float = 1.0) -> float:
    """:func:`per_send_wire_bytes` in MB, with ``payload_fraction`` applied
    (1/S for segmented gossip). Without a codec the raw size is returned
    untouched."""
    raw = payload_mb * payload_fraction
    if codec is None:
        return raw
    return per_send_wire_bytes(codec, raw * 1e6) / 1e6
