"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Layout mirrors ``repro.kernels``: per group, ``ref.py`` holds the plain
versions, one module per kernel binds its CUDA source (``csrc/*.cu``), and
``ops.py`` dispatches — a CPU tensor to the plain version, a CUDA tensor to
the kernel (or a raise; there is no fallback).

``LAUNCHES`` counts kernel launches, one per call of the C entry point, so a
run can show that its path went through the kernels; ``SHAPES`` counts the
same launches by shape (the wrapper's key: ``(rows, size, bits)`` for the
quantizer, ``(rows, size, block, k)`` for top-k, the tensor shape
elsewhere), so a kernel's time can be weighted by the shapes the path gives
it.
"""
from collections import Counter
from typing import Dict, Tuple

KERNEL_NAMES = (
    "quantize", "dequantize", "topk_select", "gossip_mix", "flash_attention", "selective_scan",
    "flash_attention_bwd", "selective_scan_bwd")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}
SHAPES: Dict[str, Counter] = {name: Counter() for name in KERNEL_NAMES}


def count_launch(name: str, shape: Tuple[int, ...]) -> None:
    """One launch of kernel ``name`` at ``shape``; the wrappers call it where
    they launch, and nowhere else."""
    LAUNCHES[name] += 1
    SHAPES[name][tuple(shape)] += 1


def reset_launches() -> None:
    for name in KERNEL_NAMES:
        LAUNCHES[name] = 0
        SHAPES[name].clear()


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def launch_shapes() -> Dict[str, Dict[Tuple[int, ...], int]]:
    return {name: dict(SHAPES[name]) for name in KERNEL_NAMES}
