"""Checkpointing of the port (``repro.checkpoint.checkpoint``): flat-keypath
``.npz`` tree save / restore and DFL round metadata, in the JAX package's
on-disk format, so a file written by either package loads in the other.

Keys are the leaves' paths joined by "/" (dict keys; list and tuple
indices), one array per leaf; metadata sits beside the file as
``<path>.meta.json``. A bfloat16 leaf is stored as its raw 16-bit patterns
(numpy dtype ``V2``), which is what ``np.savez`` writes for the JAX
package's bfloat16 arrays; f32 and integer leaves are plain arrays.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

PyTree = Any


def _paths(tree: PyTree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in ``jax.tree_util`` order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _paths(t, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_array(t: Any) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(t)


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype == np.dtype("V2"):  # raw bfloat16 bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=like.device, dtype=like.dtype)


def save_pytree(path: str, tree: PyTree, metadata: Optional[Dict[str, Any]] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz",
             **{k: _to_array(v) for k, v in _paths(tree)})
    if metadata is not None:
        with open(_meta_path(path), "w") as f:
            json.dump(metadata, f)


def restore_pytree(path: str, like: PyTree) -> PyTree:
    """Restore into the structure of ``like``, a tree of tensors (shape
    checked; dtype and device taken from ``like``)."""
    f = np.load(path if path.endswith(".npz") else path + ".npz")

    def fill(tree: PyTree, prefix: Tuple[str, ...]) -> PyTree:
        if isinstance(tree, dict):
            return {k: fill(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(t, prefix + (str(i),)) for i, t in enumerate(tree))
        key = "/".join(prefix)
        arr = f[key]
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(f"checkpoint shape mismatch at {key}: {arr.shape} vs "
                             f"{tuple(tree.shape)}")
        return _to_tensor(arr, tree)

    return fill(like, ())


def load_metadata(path: str) -> Optional[Dict[str, Any]]:
    mp = _meta_path(path)
    if not os.path.exists(mp):
        return None
    with open(mp) as f:
        return json.load(f)


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"


def node_checkpoint_path(root: str, node_id: int, round_idx: int) -> str:
    return os.path.join(root, f"node{node_id:04d}", f"round{round_idx:08d}.npz")
