"""Payload codecs of the port: the wire model and the device encode/decode."""
from .codec import (
    CODEC_NAMES,
    Bf16Codec,
    Codec,
    IdentityCodec,
    TopKCodec,
    UniformQuantCodec,
    make_codec,
    per_send_wire_bytes,
    per_send_wire_mb,
)

__all__ = [
    "CODEC_NAMES", "Bf16Codec", "Codec", "IdentityCodec", "TopKCodec",
    "UniformQuantCodec", "make_codec", "per_send_wire_bytes", "per_send_wire_mb",
]
