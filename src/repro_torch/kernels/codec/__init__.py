"""Payload-codec kernels: quantize/dequantize and top-k select+pack.

Layout mirrors ``repro.kernels.codec``: the Hopper kernels' wrappers live in
``quant_pack.py`` / ``topk_pack.py`` (sources in ``csrc/``), the plain
PyTorch versions in ``ref.py``, and the dispatching entry points in
``ops.py``.
"""
