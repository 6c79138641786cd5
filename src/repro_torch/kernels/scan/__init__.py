"""Mamba1 selective scan: the Hopper kernel's wrapper (``mamba_scan.py``,
source ``csrc/selective_scan.cu``), its plain PyTorch version (``ref.py``)
and the dispatching entry point (``ops.py``)."""
