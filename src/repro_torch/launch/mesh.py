"""Device meshes of the port (``repro.launch.mesh``): a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group.

Functions, not module-level constants: importing this module touches no
process group and no device. The production layouts are the JAX package's:
``16x16`` (256 ranks, axes ``("data", "model")``) and ``2x16x16`` (512 ranks,
``("pod", "data", "model")``). Nothing on a card's machine says how many
ranks a job has, so the caller initializes the default group itself
(``torch.distributed.init_process_group``); the dry run
(``launch/dryrun.py --mesh``) makes a ``"fake"`` group of the production
size, whose collectives move no data.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import DeviceLike, resolve_device

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def _mesh(shape: Sequence[int], axes: Sequence[str], device: DeviceLike,
          hint: str) -> DeviceMesh:
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(f"need {n} ranks for a {'x'.join(map(str, shape))} mesh, the "
                           f"default process group has {have}: {hint}")
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None) -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks) over
    the first ranks of the default process group, on the card unless
    ``device="cpu"``."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return _mesh(shape, axes, device,
                 "the dry run (python -m repro_torch.launch.dryrun --mesh "
                 f"{'x'.join(map(str, shape))}) makes a fake process group of that size")


def make_local_mesh(shape: Tuple[int, ...] = (1, 1),
                    axes: Tuple[str, ...] = ("data", "model"),
                    device: DeviceLike = None) -> DeviceMesh:
    """A mesh over the first ``prod(shape)`` ranks that exist (one rank for
    the default ``(1, 1)``), on the card unless ``device="cpu"``."""
    return _mesh(shape, axes, device, "initialize torch.distributed with enough ranks first")
