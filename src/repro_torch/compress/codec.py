"""Payload codecs: the exact wire-byte model, the payload wire and the
device encode/decode.

The wire model (:meth:`Codec.wire_bytes`, :meth:`Codec.mean_atol`,
:func:`per_send_wire_bytes`, :func:`per_send_wire_mb`) is a copy of
``repro.compress.codec``, so byte accounting agrees with the JAX package to
the bit. The device side replaces the JAX hooks: :meth:`Codec.encode` turns
a tensor into the buffers that cross the wire, :meth:`Codec.decode` turns
them back, :meth:`Codec.roundtrip` is both.

The payload wire is the reference's ``Codec.encode(tree, state)`` /
``decode(payload)``, under other names because ``encode`` / ``decode`` are
the row codecs': :meth:`Codec.encode_payload` turns a pytree of tensors
(nested dict / list / tuple; a leaf on any device) into an
:class:`EncodedPayload` of :class:`WireLeaf` objects with an exact
``bytes_on_wire == sum(wire_bytes(leaf.numel()))``, threading the codec's
error-feedback state (:meth:`Codec.init_state`: top-k keeps one residual a
leaf path); :meth:`Codec.decode_payload` gives back f32 leaves of the input
shapes. A leaf goes through the row ops as one row: a CUDA leaf launches
the quantize, dequantize and top-k kernels (or raises), a CPU leaf runs
their plain versions. This is what the queue engine
(:class:`repro_torch.core.gossip.GossipEngine`) moves.

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
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import obs
from ..kernels.codec.group import MAX_GROUP_LEAVES, group_layout
from ..kernels.codec.ops import (dequantize_group_op, dequantize_op, quantize_op,
                                 topk_scatter, topk_select_op)

Wire = Tuple[torch.Tensor, ...]
PyTree = Any


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dict / list / tuple trees."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *[t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _f32(leaf) -> torch.Tensor:
    """A leaf as an f32 tensor where it lies (a numpy array on the CPU)."""
    return torch.as_tensor(leaf).to(torch.float32)


@dataclass
class WireLeaf:
    """One encoded tensor. Opaque to the tree walkers (a plain dict would be
    recursed into by :func:`tree_map`)."""

    data: Dict[str, Any]

    def __getitem__(self, key: str) -> Any:
        return self.data[key]


@dataclass
class EncodedPayload:
    """One payload as it crosses a link: opaque data + exact byte count."""

    codec: str
    data: PyTree  # WireLeaf per tensor, mirroring the input tree structure
    bytes_on_wire: int

    def nbytes(self) -> int:
        return self.bytes_on_wire


class Codec:
    """Payload codec: exact wire bytes, error bound, device encode/decode."""

    name: str = "abstract"
    lossless: bool = False
    error_feedback: bool = False  # the trainer carries a residual for it (sparsifiers)
    grouped: bool = False  # roundtrip_group decodes several leaves at once

    def wire_bytes(self, n_elements: int) -> int:
        """Exact bytes on the wire for ``n_elements`` float32 values."""
        raise NotImplementedError

    def ratio(self, n_elements: int = 1 << 20) -> float:
        """Compression ratio vs raw fp32 (< 1 means smaller on the wire)."""
        return self.wire_bytes(n_elements) / (4 * n_elements)

    def mean_atol(self, max_abs: float) -> Optional[float]:
        """Worst-case per-element error of one encode at input magnitude
        ``max_abs``; ``None`` = no deterministic bound (sparsifiers)."""
        return 0.0 if self.lossless else None

    # -- the payload wire (the reference's encode(tree, state) / decode) -----------
    def init_state(self) -> Any:
        """Fresh per-sender residual state (None for stateless codecs)."""
        return None

    def encode_payload(self, tree: PyTree, state: Any = None) -> Tuple[EncodedPayload, Any]:
        """Encode a pytree of tensors; returns (payload, new_state)."""
        total = 0

        def enc(leaf):
            nonlocal total
            x = _f32(leaf)
            data = self._encode_leaf(x)
            total += self.wire_bytes(x.numel())
            return WireLeaf(data) if isinstance(data, dict) else data

        rec = obs.get()
        if rec.enabled:
            with rec.span(f"encode:{self.name}", cat="codec", track="codec"):
                data = tree_map(enc, tree)
            rec.count("codec.encodes")
            rec.count("codec.encoded_bytes", total)
            rec.gauge(f"codec.ratio.{self.name}", self.ratio())
        else:
            data = tree_map(enc, tree)
        return EncodedPayload(self.name, data, total), state

    def decode_payload(self, payload: EncodedPayload) -> PyTree:
        """Inverse of :meth:`encode_payload`: f32 leaves of the input shapes."""
        if payload.codec != self.name:
            raise ValueError(
                f"payload encoded with {payload.codec!r}, decoding with {self.name!r}")
        rec = obs.get()
        if rec.enabled:
            with rec.span(f"decode:{self.name}", cat="codec", track="codec"):
                out = tree_map(self._decode_leaf, payload.data)
            rec.count("codec.decodes")
            return out
        return tree_map(self._decode_leaf, payload.data)

    def _encode_leaf(self, x: torch.Tensor) -> Any:
        return x

    def _decode_leaf(self, data: Any) -> torch.Tensor:
        return data

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

    def _encode_leaf(self, x: torch.Tensor) -> Dict[str, Any]:
        # the cast rounds to nearest even, as the reference's bit arithmetic
        return {"bits": x.to(torch.bfloat16), "shape": tuple(x.shape)}

    def _decode_leaf(self, data: WireLeaf) -> torch.Tensor:
        return data["bits"].to(torch.float32).reshape(data["shape"])


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

    def _encode_leaf(self, x: torch.Tensor) -> Dict[str, Any]:
        codes, scales = quantize_op(x.reshape(1, -1), bits=self.bits, chunk=self.chunk)
        return {"codes": codes, "scales": scales, "shape": tuple(x.shape), "size": x.numel()}

    def _decode_leaf(self, data: WireLeaf) -> torch.Tensor:
        out = dequantize_op(data["codes"], data["scales"], size=data["size"], bits=self.bits,
                            chunk=self.chunk)
        return out.reshape(data["shape"])

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

    # -- the payload wire, one residual a leaf path -------------------------------
    def init_state(self) -> Any:
        return {}  # leaf path -> residual tensor, filled lazily

    def encode_payload(self, tree: PyTree, state: Any = None) -> Tuple[EncodedPayload, Any]:
        """Encode with error feedback: each leaf's residual of the previous
        encode (keyed by its path, ``"a/0/b"``) is added first, and what this
        encode drops becomes the leaf's new residual."""
        new_state: Dict[str, torch.Tensor] = {}
        total = 0
        path: List[str] = []

        def enc(leaf):
            nonlocal total
            x = _f32(leaf)
            key = "/".join(path)
            if state and key in state:
                x = x + state[key]
            data, residual = self._encode_leaf_ef(x)
            new_state[key] = residual
            total += self.wire_bytes(x.numel())
            return WireLeaf(data)

        def walk(t):
            if isinstance(t, dict):
                return {k: _at(k, t[k]) for k in t}
            if isinstance(t, (list, tuple)):
                return type(t)(_at(str(i), x) for i, x in enumerate(t))
            return enc(t)

        def _at(key, sub):
            path.append(key)
            try:
                return walk(sub)
            finally:
                path.pop()

        return EncodedPayload(self.name, walk(tree), total), new_state

    def _encode_leaf_ef(self, x: torch.Tensor) -> Tuple[Dict[str, Any], torch.Tensor]:
        vals, idx = topk_select_op(x.reshape(1, -1), k=self.k, block=self.block)
        kept = topk_scatter(vals, idx, size=x.numel(), block=self.block).reshape(x.shape)
        return ({"values": vals, "indices": idx, "shape": tuple(x.shape), "size": x.numel()},
                x - kept)

    def _encode_leaf(self, x: torch.Tensor) -> Dict[str, Any]:
        return self._encode_leaf_ef(x)[0]

    def _decode_leaf(self, data: WireLeaf) -> torch.Tensor:
        out = topk_scatter(data["values"], data["indices"], size=data["size"], block=self.block)
        return out.reshape(data["shape"])


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
