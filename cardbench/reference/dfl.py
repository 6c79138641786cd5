"""Plain reference of the DFL step the benchmark times
(``DFLTrainer.train_step`` on N nodes stacked on one card).

One step, as the port states it: node i takes the cross-entropy and its
gradient at its own parameters on its own rows; the step's loss and
gradient are the global batch's (node i weighs by its share of the valid
labels); the mean gradient is clipped by its global norm; AdamW (one pair of
moments, a cosine schedule) updates every node's float32 master with it;
then one gossip round on the masters: the tree all-reduce leaves every node
at the mean, the dissemination round leaves node i at the mean of its own
master and what the wire delivers of the others' (the int8 wire below).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch

from . import dense, mamba1
from .numerics import MatMul
from .weights import flatten, hyper

LOSSES = {"dense": dense.loss, "mamba1": mamba1.loss}
INT8_CHUNK = 1024
INT8_QMAX = 127.0


def cosine_lr(step: int, lr: float, warmup: int, total: int, final_frac: float) -> float:
    if step < warmup:
        return lr * min(step / max(warmup, 1), 1.0)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return lr * (final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * prog)))


def int8_roundtrip(rows: torch.Tensor) -> torch.Tensor:
    """What the int8 wire delivers of (N, size) payloads: each row cut into
    chunks of 1024 (the last zero-padded), a chunk's codes
    ``clamp(round_half_even(x / s), -127, 127)`` with ``s = absmax / 127``
    (IEEE divides; s = 1 for an all-zero chunk), decoded as ``code * s``."""
    n, size = rows.shape
    pad = (-size) % INT8_CHUNK
    x = torch.nn.functional.pad(rows.float(), (0, pad)).view(n, -1, INT8_CHUNK)
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, INT8_QMAX), torch.ones_like(amax))
    codes = torch.clamp(torch.round(x / scale), -INT8_QMAX, INT8_QMAX)
    return (codes * scale).view(n, -1)[:, :size]


def gossip(master: torch.Tensor, mode: str, codec: str) -> torch.Tensor:
    """One round on a leaf's (N, ...) masters."""
    n = master.shape[0]
    if mode == "tree_allreduce" and codec == "":
        return master.mean(dim=0, keepdim=True).expand_as(master).clone()
    if mode == "dissemination" and codec in ("", "int8"):
        flat = master.reshape(n, -1)
        wire = int8_roundtrip(flat) if codec == "int8" else flat
        total = wire.sum(dim=0, keepdim=True)
        # node i keeps its own master and takes the others' from the wire
        return ((total - wire + flat) / n).view_as(master)
    raise NotImplementedError(f"no reference for gossip {mode!r} with codec {codec!r}")


def run_steps(cfg: Dict[str, Any], traffic: Dict[str, Any], starts: Sequence[Dict[str, Any]],
              batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], mm: MatMul
              ) -> Dict[str, Any]:
    """The reference's first ``len(batches)`` steps from ``starts`` (the
    benchmark's weights of each node, ``weights.node_params``). Returns each
    step's loss, each node's loss of each step, each leaf's norm of the
    first clipped gradient and each leaf's norm of the masters' change over
    the steps (every node from its own start), by path."""
    hp, opt = hyper(cfg), cfg["optimizer"]
    n, rows = traffic["nodes"], traffic["rows_per_node"]
    if len(starts) != n:
        raise ValueError(f"{len(starts)} starts for {n} nodes")
    loss_fn = LOSSES[cfg["reference"]]
    flats = [dict(flatten(s)) for s in starts]
    paths = list(flats[0])
    start = {p: torch.stack([f[p] for f in flats]) for p in paths}
    del flats
    master = {p: t.float() for p, t in start.items()}
    m = {p: torch.zeros_like(t[0], dtype=torch.float32) for p, t in start.items()}
    v = {p: torch.zeros_like(t[0], dtype=torch.float32) for p, t in start.items()}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses: List[float] = []
    node_losses: List[List[float]] = []
    first_grad: Dict[str, float] = {}
    for k, (tokens, labels) in enumerate(batches):
        total = float((labels >= 0).sum())
        acc = {p: torch.zeros_like(t) for p, t in m.items()}
        step_loss, nodes = 0.0, []
        for i in range(n):
            sl = slice(i * rows, (i + 1) * rows)
            live = {p: master[p][i].detach().requires_grad_(True) for p in paths}
            tree = _unflatten(live)
            w = float((labels[sl] >= 0).sum()) / total
            loss = loss_fn(tree, hp, tokens[sl], labels[sl], mm)
            grads = torch.autograd.grad(loss, [live[p] for p in paths])
            for p, g in zip(paths, grads):
                acc[p].add_(g, alpha=w)
            nodes.append(float(loss.detach()))
            step_loss += w * nodes[-1]
            del live, tree, loss, grads
        norm = math.sqrt(sum(float(g.square().sum()) for g in acc.values()))
        scale = min(traffic["max_grad_norm"] / max(norm, 1e-9), 1.0)
        lr = cosine_lr(k, traffic["lr"], traffic["warmup"], traffic["total_steps"],
                       opt["final_frac"])
        bc1, bc2 = 1 - b1 ** (k + 1), 1 - b2 ** (k + 1)
        for p in paths:
            g = acc[p].mul_(scale)
            if k == 0:
                first_grad[p] = float(g.norm())
            m[p].mul_(b1).add_(g, alpha=1 - b1)
            v[p].mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (m[p] / bc1) / (torch.sqrt(v[p] / bc2) + eps)
            master[p] = master[p] - lr * (upd + wd * master[p])
            if (k + 1) % max(traffic["gossip_interval"], 1) == 0:
                master[p] = gossip(master[p], traffic["gossip_mode"], traffic["codec"])
        del acc
        losses.append(step_loss)
        node_losses.append(nodes)
    change = {p: float((master[p] - start[p].float()).norm()) for p in paths}
    return {"losses": losses, "node_losses": node_losses, "first_grad": first_grad,
            "change": change}


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, t in flat.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return tree
