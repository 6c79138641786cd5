"""Optimizers of the port (``repro.optim.optimizers``): schedules, global-norm
clipping, SGD, momentum, AdamW and Adafactor as plain functions on tensor
trees (nested dicts / lists / tuples); the step is a tensor.

The arithmetic is the JAX package's, op for op in f32. Updates broadcast:
the DFL trainer keeps parameters and fp32 masters with a leading node axis
``(N, ...)`` and the moments once (every node applies the same mean
gradient, as the reference does under GSPMD), so a gradient or moment of a
leaf's own shape meets a ``(N, ...)`` parameter and each node's row updates
with it. Nothing reduces over that node axis: Adafactor's factorisation and
its ``rms_u`` read the gradient's own rank and elements. A moment that the
update makes depend on the parameters (momentum with weight decay) comes
out per node.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import torch

from ..dfl.collectives import tree_map

Params = Any
PyTree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


def tree_leaves(tree: PyTree) -> List[torch.Tensor]:
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def _f32(step: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32, device=torch.as_tensor(step).device)


def cosine_schedule(lr: float, warmup: int, total: int, final_frac: float = 0.1) -> Schedule:
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = _f32(step)
        warm = lr * torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, lr * cos)

    return fn


def linear_schedule(lr: float, warmup: int, total: int) -> Schedule:
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = _f32(step)
        warm = lr * torch.clamp(step / max(warmup, 1), max=1.0)
        decay = lr * torch.clamp(1 - (step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return torch.where(step < warmup, warm, decay)

    return fn


# ---------------------------------------------------------------------------
# gradient utilities
# ---------------------------------------------------------------------------


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves (in ``jax.tree.leaves`` order) of each
    leaf's f32 sum of squares."""
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree: PyTree, max_norm: float) -> Tuple[PyTree, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Optimizer:
    """(init, update) pair. ``update(params, grads, state, step)`` returns
    ``(new_params, new_state)``."""

    init: Callable[[Params], PyTree]
    update: Callable[[Params, PyTree, PyTree, torch.Tensor], Tuple[Params, PyTree]]
    name: str = "optimizer"


def _unzip(out: PyTree, like: PyTree, n: int) -> List[PyTree]:
    """``out`` holds an n-tuple at each leaf of ``like`` -> n trees shaped
    like ``like``."""
    if isinstance(like, dict):
        parts = {k: _unzip(out[k], like[k], n) for k in like}
        return [{k: parts[k][i] for k in like} for i in range(n)]
    if isinstance(like, (list, tuple)):
        parts = [_unzip(o, x, n) for o, x in zip(out, like)]
        return [type(like)(p[i] for p in parts) for i in range(n)]
    return list(out)


def sgd(schedule: Schedule, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {}

    def update(params, grads, state, step):
        lr = schedule(step)

        def upd(p, g):
            g32 = g.float()
            p32 = p.float()
            if weight_decay:
                g32 = g32 + weight_decay * p32
            return (p32 - lr * g32).to(p.dtype)

        return tree_map(upd, params, grads), state

    return Optimizer(init, update, "sgd")


def momentum_sgd(schedule: Schedule, beta: float = 0.9, weight_decay: float = 0.0,
                 moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params):
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device),
                              params)}

    def update(params, grads, state, step):
        lr = schedule(step)

        def upd(p, g, m):
            g32 = g.float()
            if weight_decay:
                g32 = g32 + weight_decay * p.float()
            m32 = beta * m.float() + g32
            return (p.float() - lr * m32).to(p.dtype), m32.to(moment_dtype)

        new_p, new_m = _unzip(tree_map(upd, params, grads, state["m"]), params, 2)
        return new_p, {"m": new_m}

    return Optimizer(init, update, "momentum_sgd")


def adamw(schedule: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, moment_dtype: torch.dtype = torch.float32,
          master_fp32: bool = True) -> Optimizer:
    """AdamW with a configurable moment dtype and optional fp32 master
    weights (the update then starts from, and writes, the master)."""

    def init(params):
        state = {
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device),
                          params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device),
                          params),
        }
        if master_fp32:
            state["master"] = tree_map(lambda p: p.float().clone(), params)
        return state

    def update(params, grads, state, step):
        lr = schedule(step)
        t = _f32(step) + 1.0
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)

        def upd(p, g, m, v, master):
            g32 = g.float()
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
            mhat = m32 / bc1
            vhat = v32 / bc2
            base = master.float() if master is not None else p.float()
            step_vec = mhat / (torch.sqrt(vhat) + eps) + weight_decay * base
            new_master = base - lr * step_vec
            return (new_master.to(p.dtype), m32.to(moment_dtype), v32.to(moment_dtype),
                    new_master if master is not None else None)

        masters = state.get("master")
        if masters is None:
            out = tree_map(lambda p, g, m, v: upd(p, g, m, v, None),
                           params, grads, state["m"], state["v"])
        else:
            out = tree_map(upd, params, grads, state["m"], state["v"], masters)
        new_p, new_m, new_v, new_master = _unzip(out, params, 4)
        new_state = {"m": new_m, "v": new_v}
        if masters is not None:
            new_state["master"] = new_master
        return new_p, new_state

    return Optimizer(init, update, "adamw")


def adafactor(schedule: Schedule, b2: float = 0.999, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0) -> Optimizer:
    """Adafactor (Shazeer & Stern) without momentum: the second moment of any
    rank >= 2 leaf is stored as a rank-1 row / column factorisation."""

    def init(params):
        def leaf(p):
            z = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}

        return {"f": tree_map(leaf, params)}

    def update(params, grads, state, step):
        lr = schedule(step)

        def upd(p, g, st):
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if g.dim() >= 2:  # the leaf's own rank: p may carry a node axis
                vr = b2 * st["vr"] + (1 - b2) * g2.mean(dim=-1)
                vc = b2 * st["vc"] + (1 - b2) * g2.mean(dim=-2)
                denom = vr[..., :, None] * vc[..., None, :] / torch.clamp(
                    vr.mean(dim=-1)[..., None, None], min=eps)
                u = g32 / torch.sqrt(torch.clamp(denom, min=eps))
                new_st = {"vr": vr, "vc": vc}
            else:
                v = b2 * st["v"] + (1 - b2) * g2
                u = g32 / torch.sqrt(torch.clamp(v, min=eps))
                new_st = {"v": v}
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            p32 = p.float()
            if weight_decay:
                u = u + weight_decay * p32
            return (p32 - lr * u).to(p.dtype), new_st

        # the state tree mirrors params with a dict at each leaf: tree_map
        # follows params and hands upd that leaf's dict
        new_p, new_f = _unzip(tree_map(upd, params, grads, state["f"]), params, 2)
        return new_p, {"f": new_f}

    return Optimizer(init, update, "adafactor")


def make_optimizer(cfg, lr: float = 3e-4, warmup: int = 100, total: int = 10_000) -> Optimizer:
    """Arch-aware optimizer (kind / moment dtype / master copy from ArchConfig)."""
    kind = getattr(cfg, "optimizer", "adamw")
    sched = cosine_schedule(lr, warmup, total)
    if kind == "adafactor":
        return adafactor(sched)
    moment_dtype = torch.bfloat16 if cfg.optimizer_dtype == "bfloat16" else torch.float32
    if kind == "momentum":
        return momentum_sgd(sched, moment_dtype=moment_dtype)
    return adamw(sched, moment_dtype=moment_dtype, master_fp32=cfg.use_master_fp32)
