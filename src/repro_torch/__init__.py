"""PyTorch/CUDA port of the MOSGU reproduction (``repro``), for one NVIDIA H100.

The package mirrors ``repro`` module for module. The numpy control plane
(graphs, MST, coloring, slot plans, perm-step lowering, churn membership) is
carried as the port's own trimmed copy; the device side (the gossip
collectives, the wire codecs and the FedAvg mix) runs on torch tensors, with
hand-written Hopper kernels under ``kernels/`` and ``csrc/``.

Entry points run on the card unless the caller passes ``device="cpu"``
(:func:`resolve_device`); there is no silent CPU fallback. The dry run
(``launch/dryrun.py``) traces on fake tensors, which touch no card: while
its fake mode is active, CUDA may be asked for without one.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (or defaulted to) and absent,
    unless a fake mode is active (the dry run's, whose tensors need no card)."""
    dev = torch.device("cuda" if device is None else device)
    faking = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None
    if dev.type == "cuda" and not torch.cuda.is_available() and not faking:
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
