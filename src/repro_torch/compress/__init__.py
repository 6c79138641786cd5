"""Payload codecs of the port: the wire model, the payload wire the queue
engine moves, and the device encode/decode."""
from .codec import (
    CODEC_NAMES,
    Bf16Codec,
    Codec,
    EncodedPayload,
    IdentityCodec,
    TopKCodec,
    UniformQuantCodec,
    WireLeaf,
    make_codec,
    per_send_wire_bytes,
    per_send_wire_mb,
)

__all__ = [
    "CODEC_NAMES", "Bf16Codec", "Codec", "EncodedPayload", "IdentityCodec", "TopKCodec",
    "UniformQuantCodec", "WireLeaf", "make_codec", "per_send_wire_bytes", "per_send_wire_mb",
]
