"""Sharding recipes of the port (``repro.dfl.sharding``): ArchConfig + mesh
-> a tree of :class:`Spec`, one per leaf, and from specs to DTensor
placements.

Rules, the JAX package's (DESIGN.md §4):
  * within a DFL node, tensor-parallel over the "model" axis (Megatron):
    attention heads when divisible, else that projection is replicated;
    d_ff, d_inner and the padded vocab always shard;
  * experts shard over ``cfg.expert_axis`` (the moe archs use the data axis
    for expert parallelism);
  * batch shards over ("pod", "data") whenever divisible;
  * decode caches: batch over the node axes, kv heads (or head_dim) over
    "model", and, when the batch cannot be split (long_500k), the cache's
    sequence over "data".

Anything not matched is replicated. Every rule checks divisibility against
the mesh, so one recipe serves a one-rank mesh, the 256-rank pod and the
512-rank multi-pod mesh.

A :class:`Spec` mirrors ``jax.sharding.PartitionSpec``: one entry a
dimension, each None, an axis name or a tuple of axis names (major to
minor); missing trailing entries are None. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` or anything with a ``.shape``
dict of axis sizes (the spec builders read sizes only).

Two ways to DTensors: :func:`distribute_tree` splits full tensors (each
rank keeps its shard), :func:`local_param_tree` / :func:`local_zeros_tree`
make each rank's shards directly, seeded, so no rank ever holds a whole
tensor (60 GB of qwen3-moe or 960 GB of arctic on one rank would not fit).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

from ..configs.base import ArchConfig

Entry = Optional[Any]  # None, an axis name, or a tuple of axis names


class Spec(tuple):
    """Per-dimension axis names of one leaf (``PartitionSpec``'s role)."""

    def __new__(cls, *entries: Entry) -> "Spec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a duck mesh's ``.shape``."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def _axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _div(n: int, sizes: Dict[str, int], axis: str) -> bool:
    return axis in sizes and sizes[axis] > 1 and n % sizes[axis] == 0


def _map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any,
                   path: Tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _is_spec(x: Any) -> bool:
    return isinstance(x, Spec)


def map_specs(fn: Callable, spec_tree: Any, *trees: Any) -> Any:
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure."""
    if _is_spec(spec_tree):
        return fn(spec_tree, *trees)
    return {k: map_specs(fn, v, *(t[k] for t in trees)) for k, v in spec_tree.items()}


# -- batch -------------------------------------------------------------------------------

def batch_axes(mesh: Any, batch: int) -> Tuple[str, ...]:
    """Largest prefix of ("pod", "data") that divides the batch."""
    sizes = axis_sizes(mesh)
    chosen: Tuple[str, ...] = ()
    n = 1
    for a in ("pod", "data"):
        if a in sizes and batch % (n * sizes[a]) == 0:
            chosen += (a,)
            n *= sizes[a]
    return chosen


def batch_spec(mesh: Any, batch: int, rank: int) -> Spec:
    ba = batch_axes(mesh, batch)
    return Spec(ba if ba else None, *([None] * (rank - 1)))


# -- parameters -------------------------------------------------------------------------

def param_spec_tree(cfg: ArchConfig, params: Any, mesh: Any) -> Any:
    """A Spec tree mirroring ``params`` (stacked layers keep leading Nones);
    leaves need only ``.shape`` and ``.ndim``."""
    m = "model"
    sizes = axis_sizes(mesh)
    e_ax = cfg.expert_axis if cfg.expert_axis in sizes else None
    model_n = sizes.get(m, 1)

    def div_m(n: int) -> Optional[str]:
        return m if _div(n, sizes, m) else None

    def heads(n_heads: int) -> Optional[str]:
        # shard the head dim when divisible, else replicate the projection;
        # never head_dim (an hd-split QK^T all-reduces the whole scores)
        return m if model_n > 1 and n_heads % model_n == 0 else None

    def rule(path: Tuple[str, ...], leaf: Any) -> Spec:
        name = path[-1] if path else ""
        parent = path[-2] if len(path) > 1 else ""
        rank = leaf.ndim
        shape = leaf.shape
        if name == "table":  # embedding (padded vocab, d)
            trail = (div_m(shape[0]), None)
        elif parent in ("attn", "cross") and name in ("wq", "wk", "wv"):
            trail = (None, heads(shape[-2]), None)
        elif parent in ("attn", "cross") and name == "wo":
            trail = (heads(shape[-3]), None, None)
        elif parent in ("mlp", "dense") and name in ("wg", "wi"):
            trail = (None, div_m(shape[-1]))
        elif parent in ("mlp", "dense") and name == "wo":
            trail = (div_m(shape[-2]), None)
        elif parent == "moe" and name in ("wg", "wi"):  # (e, d, f)
            trail = (e_ax, None, div_m(shape[-1]))
        elif parent == "moe" and name == "wo":  # (e, f, d)
            trail = (e_ax, div_m(shape[-2]), None)
        elif name == "router":
            trail = (None, None)
        elif name in ("wx", "wz", "conv_w", "dt_proj"):  # (d | w | r, di)
            trail = (None, div_m(shape[-1]))
        elif name in ("wdt_in", "out_proj"):  # (di, r | d)
            trail = (div_m(shape[-2]), None)
        elif name in ("wB", "wC"):  # (di | d, n)
            lead = (div_m(shape[-2]) if parent == "body" and cfg.ssm_version == 1 else None)
            trail = (lead, None)
        elif name in ("dt_bias", "D") and rank >= 1 and shape[-1] > 1024:
            trail = (div_m(shape[-1]),)
        elif name == "A_log" and cfg.ssm_version == 1 and rank >= 2:  # (di, n)
            trail = (div_m(shape[-2]), None)
        elif name == "wdt":  # mamba2 (d, h)
            trail = (None, None)
        else:  # norms, scalars, biases
            return Spec()
        n_lead = rank - len(trail)
        if n_lead < 0:
            return Spec()
        return Spec(*([None] * n_lead), *trail)

    return _map_with_path(rule, params)


# -- decode caches ------------------------------------------------------------------------

def cache_spec_tree(cfg: ArchConfig, cache: Any, mesh: Any, batch: int) -> Any:
    m = "model"
    sizes = axis_sizes(mesh)
    ba = batch_axes(mesh, batch)
    b_ax = ba if ba else None
    shard_seq = not ba  # batch unshardable (long_500k): the cache's sequence on data

    def rule(path: Tuple[str, ...], leaf: Any) -> Spec:
        name = path[-1] if path else ""
        rank = leaf.ndim
        if name in ("k", "v") or name.startswith("cross_"):
            # (L, b, c, K, hd) or (n_super, b, c, K, hd)
            kv, hd = leaf.shape[-2], leaf.shape[-1]
            h_ax = m if _div(kv, sizes, m) else None
            d_ax = m if (h_ax is None and _div(hd, sizes, m)) else None
            c_ax = "data" if (shard_seq and _div(leaf.shape[-3], sizes, "data")) else None
            return Spec(*([None] * (rank - 4)), b_ax, c_ax, h_ax, d_ax)
        if name == "conv":  # (L..., b, w-1, di)
            d_ax = m if _div(leaf.shape[-1], sizes, m) else None
            return Spec(*([None] * (rank - 3)), b_ax, None, d_ax)
        if name == "ssm":  # mamba1 (L, b, di, n) / mamba2 (L, b, h, hd, n)
            if cfg.ssm_version == 2 and rank >= 4:
                h_ax = m if _div(leaf.shape[-3], sizes, m) else None
                return Spec(*([None] * (rank - 4)), b_ax, h_ax, None, None)
            d_ax = m if _div(leaf.shape[-2], sizes, m) else None
            return Spec(*([None] * (rank - 3)), b_ax, d_ax, None)
        return Spec()

    return _map_with_path(rule, cache)


# -- placements and DTensors ------------------------------------------------------------------

def placements(mesh: Any, spec: Spec) -> Tuple[Placement, ...]:
    """A Spec as DTensor placements, one a mesh dimension: ``Shard(d)`` on
    each mesh dimension that an entry of dimension d names, ``Replicate()``
    on the others."""
    names = list(axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for ax in _axes(entry):
            out[names.index(ax)] = Shard(d)
    return tuple(out)


def named(mesh: Any, spec_tree: Any) -> Any:
    """The placements of every leaf of a spec tree (``NamedSharding``'s role)."""
    return map_specs(lambda s: placements(mesh, s), spec_tree)


def local_shape(mesh: Any, spec: Spec, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """A rank's shard shape: each dimension over the product of its axes."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _axes(entry))
        if out[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not divide over {entry}")
        out[d] //= n
    return tuple(out)


def distribute_tree(mesh: Any, tree: Any, specs: Any) -> Any:
    """Full tensors -> DTensors split by their specs (each rank keeps its
    shard of the tensor it was given)."""
    return map_specs(lambda s, t: distribute_tensor(t, mesh, placements(mesh, s)), specs, tree)


def _from_local(mesh: Any, spec: Spec, local: torch.Tensor, shape: Tuple[int, ...]) -> DTensor:
    stride, n = [], 1
    for size in reversed(shape):
        stride.insert(0, n)
        n *= size
    return DTensor.from_local(local, mesh, placements(mesh, spec), run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _fill(path: Tuple[str, ...], shape: Tuple[int, ...], dtype: torch.dtype,
          gen: torch.Generator, device: torch.device, ssm_version: int) -> torch.Tensor:
    """One local shard drawn as ``Model.init`` draws the leaf: norms and
    Mamba2's A_log 0, dt_bias 0, D 1, Mamba1's A_log log(1..n) a row,
    conv_w N(0, 0.5), everything else N(0, 0.02)."""
    name = path[-1]
    if name == "A_log" and ssm_version == 1:
        n = shape[-1]
        return torch.log(torch.arange(1, n + 1, dtype=dtype, device=device)).expand(
            shape).contiguous()
    if name == "D":
        return torch.ones(shape, dtype=dtype, device=device)
    if name in ("A_log", "dt_bias") or not dtype.is_floating_point or name.startswith("ln") \
            or name.endswith("norm"):
        return torch.zeros(shape, dtype=dtype, device=device)
    scale = 0.5 if name == "conv_w" else 0.02
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def local_param_tree(cfg: ArchConfig, mesh: Any, shapes: Any, specs: Any, seed: int = 0,
                     device: Any = None) -> Any:
    """DTensor params of ``cfg`` made from each rank's own shards: ``shapes``
    a tree of tensors whose shape and dtype are read (fake tensors, e.g.
    :func:`param_shapes`), the shards drawn from ``seed`` and the rank's
    global rank on ``device`` (the mesh's device type by default)."""
    dev = torch.device(device if device is not None else mesh.device_type)
    gen = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + mesh.get_rank())

    def make(path: Tuple[str, ...], leaf: Any) -> DTensor:
        spec = _spec_at(specs, path)
        local = _fill(path, local_shape(mesh, spec, leaf.shape), leaf.dtype, gen, dev,
                      cfg.ssm_version)
        return _from_local(mesh, spec, local, tuple(leaf.shape))

    return _map_with_path(make, shapes)


def local_zeros_tree(mesh: Any, shapes: Any, specs: Any, device: Any = None) -> Any:
    """DTensors of zeros (a decode cache, a batch of token ids) made from
    each rank's own shards."""
    dev = torch.device(device if device is not None else mesh.device_type)

    def make(path: Tuple[str, ...], leaf: Any) -> DTensor:
        spec = _spec_at(specs, path)
        local = torch.zeros(local_shape(mesh, spec, leaf.shape), dtype=leaf.dtype, device=dev)
        return _from_local(mesh, spec, local, tuple(leaf.shape))

    return _map_with_path(make, shapes)


def _spec_at(specs: Any, path: Tuple[str, ...]) -> Spec:
    for k in path:
        specs = specs[k]
    return specs


def param_shapes(model: Any) -> Any:
    """The params tree of ``model`` as fake tensors (shapes and dtypes, no
    data), from ``Model.init`` traced under a ``FakeTensorMode`` (the active
    one, if any)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
        return model.init(torch.Generator().manual_seed(0))
    with FakeTensorMode():
        return model.init(torch.Generator().manual_seed(0))
