"""Carry weights and state between the JAX package and the port.

The JAX package keeps one node's parameters per device, sharded over the
node axis (``P("data")``); ``np.asarray`` of such a pytree gives numpy
arrays with a leading node axis — exactly the port's stacked layout. These
functions map that nested dict / list / tuple tree (parameters, or a state
dict holding the ``codec_ef`` residual tree) to tensors and back, leaf for
leaf, bit for bit. bfloat16 leaves cross as their raw 16-bit patterns.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import DeviceLike, resolve_device
from .dfl.collectives import tree_map

PyTree = Any


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes  # numpy's bfloat16 type, which ships with JAX
        except ImportError:
            raise RuntimeError(
                "to_numpy: a bfloat16 leaf crosses back as ml_dtypes.bfloat16, the "
                "type JAX arrays carry; ml_dtypes is not installed here. Take "
                "`.float()` of the leaf first, or compare as tensors") from None
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def from_numpy(tree: PyTree, device: DeviceLike = None) -> PyTree:
    """Stacked numpy pytree (leading node axis) -> the same tree of tensors
    on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def to_numpy(tree: PyTree) -> PyTree:
    """Inverse of :func:`from_numpy`: host numpy arrays, same tree.

    bfloat16 leaves come back as ``ml_dtypes.bfloat16`` arrays, a package
    that JAX brings: handing bf16 state back to the JAX package is a test's
    job, and nothing on the card's path calls this."""
    return tree_map(_to_array, tree)
