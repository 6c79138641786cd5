"""Mamba1 selective scan: the Hopper kernels' wrappers (``mamba_scan.py``,
sources ``csrc/selective_scan.cu`` and its backward
``csrc/selective_scan_bwd.cu``), their plain PyTorch versions (``ref.py``)
and the dispatching entry point with its autograd Function (``ops.py``)."""
