"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Layout mirrors ``repro.kernels``: per group, ``ref.py`` holds the plain
versions, one module per kernel binds its CUDA source (``csrc/*.cu``), and
``ops.py`` dispatches — a CPU tensor to the plain version, a CUDA tensor to
the kernel (or a raise; there is no fallback).

``LAUNCHES`` counts kernel launches, one per call of the C entry point, so a
run can show that its path went through the kernels.
"""
from typing import Dict

KERNEL_NAMES = (
    "quantize", "dequantize", "topk_select", "gossip_mix", "flash_attention", "selective_scan")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}


def reset_launches() -> None:
    for name in KERNEL_NAMES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)
