"""codec_roofline_pct (per layer, ``kernels/codec``): the least time the
card needs for a round's int8 wire (each node's payload encoded once, each
node decoding the N - 1 payloads it receives) over the profiled device time
a step of the quantize and dequantize kernels.

Frozen copy of the port's ``quantize_cost`` / ``dequantize_cost``
(``kernels/codec/quant_pack.py``) for the int8 wire, per leaf of P elements
in chunks of 1024: an encode reads 4 P bytes of f32 and writes a code byte
an element of every chunk and an f32 scale a chunk, 5 operations an element;
a decode reads the codes and scales and writes 4 P bytes, one operation an
element. The program's re-encodes at each relay are its own choice and not
counted: the work is the wire's, whatever implements it.
"""
import re

import peaks
import profiled

PATTERN = re.compile(r"\b(quantize_kernel|dequantize_kernel|dequantize_cta_kernel)\b")
CHUNK = 1024


def step_bound_s(leaf_sizes, nodes: int) -> float:
    chunks = sum(-(-p // CHUNK) for p in leaf_sizes)
    elems = sum(leaf_sizes)
    wire = chunks * CHUNK + 4 * chunks
    encode = peaks.bound_s(5 * nodes * elems, nodes * (4 * elems + wire))
    receives = nodes * (nodes - 1)
    decode = peaks.bound_s(receives * elems, receives * (wire + 4 * elems))
    return encode + decode


def read(ctx):
    rec, t = ctx["profile"], ctx["traffic"]
    if rec is None or t["codec"] != "int8":
        return None
    sec = profiled.kernel_s(rec, PATTERN) / ctx["profiled_steps"]
    return 100.0 * step_bound_s(ctx["leaf_sizes"], t["nodes"]) / sec if sec > 0 else None
