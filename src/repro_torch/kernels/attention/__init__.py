"""Flash attention: the Hopper kernel's wrapper (``flash.py``, source
``csrc/flash_attention.cu``), its plain PyTorch version (``ref.py``) and the
dispatching entry point (``ops.py``)."""
