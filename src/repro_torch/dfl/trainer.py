"""DFL trainer of the port (``repro.dfl.trainer``): local steps and MOSGU
gossip rounds on N node replicas stacked on one device.

State layout. Parameters, the optimizer's fp32 masters and the codec's
error-feedback residual (``opt_state["codec_ef"]``) carry a leading node
axis ``(N, ...)``: they are what gossip moves, and what may differ between
nodes. The optimizer moments are held once.

Step semantics: those of the JAX trainer as it computes, not as its
docstring reads (ROADMAP R9). There ``jax.value_and_grad`` of the global
batch's loss runs with the parameters replicated over the node axes and the
batch sharded over them, so GSPMD averages the gradient across nodes and
every node applies the same clipped mean gradient to its own parameters;
nodes differ only by what a lossy gossip wire leaves. Here:

1. node i takes ``train_loss`` and its gradient at its own parameters on its
   own ``batch_per_node`` rows (in ``FederatedData.global_batch``'s node
   order), with ``cfg.microbatches`` accumulated in f32 within those rows;
2. the step's gradient is the mean over nodes (accumulated in f32, then in
   the parameters' dtype, as the reference's gradients are), its loss the
   mean of the nodes' losses;
3. ``clip_by_global_norm`` clips that mean (one norm, ``grad_norm``), and the
   optimizer updates every node's parameters and masters with it;
4. gossip runs through :func:`gossip_exchange` on the masters when they
   exist (then re-cast into the parameters), otherwise on the parameters,
   every ``gossip_interval`` steps (when ``(step + 1) % interval == 0``),
   with the wire dtype, codec and error feedback of the JAX trainer.

Nothing reduces over the node axis by accident: the per-node gradients
come from per-node forwards, and the optimizers broadcast a leaf-shaped
gradient over the node rows (``repro_torch.optim``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import DeviceLike, resolve_device
from ..compress import make_codec
from ..models.model import Batch, Model
from ..optim.optimizers import Optimizer, clip_by_global_norm, make_optimizer
from .collectives import GossipPlan, gossip_exchange, tree_map

PyTree = Any


@dataclass
class DFLConfig:
    gossip_mode: str = "tree_allreduce"  # see collectives.GOSSIP_BODIES
    gossip_interval: int = 1  # local steps between gossip rounds
    max_grad_norm: float = 1.0
    wire_dtype: str = ""  # "" = native; "bfloat16" compresses gossip payloads
    # payload codec for the gossip wire ("bf16", "int8", "int4", "topk"; "" =
    # raw). Sparsifying codecs carry an error-feedback residual in
    # opt_state["codec_ef"] (dissemination mode).
    codec: str = ""
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000


@dataclass
class TrainState:
    params: PyTree  # (N, ...) per leaf
    opt_state: Dict[str, PyTree]  # moments once; "master", "codec_ef" (N, ...)
    step: torch.Tensor  # () int32


def _stack(tree: PyTree, n: int, dtype: Optional[torch.dtype] = None) -> PyTree:
    """Each leaf repeated over a new leading node axis of n."""
    return tree_map(lambda t: t.to(dtype or t.dtype).unsqueeze(0).repeat(
        n, *([1] * t.dim())), tree)


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


class DFLTrainer:
    """One DFL step on ``n_nodes`` stacked replicas. With ``timed`` the step
    synchronizes the device between its phases and reports each phase's
    seconds by host clock in ``metrics["times"]``."""

    def __init__(self, model: Model, n_nodes: int, dfl: Optional[DFLConfig] = None,
                 optimizer: Optional[Optimizer] = None, device: DeviceLike = None,
                 timed: bool = False):
        self.model = model
        self.cfg = model.cfg
        self.n_nodes = int(n_nodes)
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"the model runs on {model.device}, the trainer on {self.device}")
        self.dfl = dfl or DFLConfig()
        self.opt = optimizer or make_optimizer(
            self.cfg, self.dfl.lr, self.dfl.warmup, self.dfl.total_steps)
        self.plan = GossipPlan.build(self.n_nodes)
        self.codec = make_codec(self.dfl.codec) if self.dfl.codec else None
        # only the dissemination collective supports error feedback; other
        # codec modes run the sparsifier without it
        self.error_feedback = (self.codec is not None and self.codec.error_feedback
                               and self.dfl.gossip_mode == "dissemination")
        self.timed = timed

    # -- init -----------------------------------------------------------------
    def init_state(self, gen: torch.Generator) -> TrainState:
        """Every node starts from the same ``Model.init`` draw."""
        return self.state_from_params(self.model.init(gen))

    def state_from_params(self, params: PyTree) -> TrainState:
        """The train state of N nodes that all start from one node's
        ``params`` (no node axis)."""
        n = self.n_nodes
        opt_state = self.opt.init(params)
        if "master" in opt_state:
            opt_state["master"] = _stack(opt_state["master"], n)
        if self.error_feedback:
            opt_state["codec_ef"] = tree_map(
                lambda p: torch.zeros((n, *p.shape), dtype=torch.float32, device=p.device),
                params)
        return TrainState(params=_stack(params, n), opt_state=opt_state,
                          step=torch.zeros((), dtype=torch.int32, device=self.device))

    # -- gradients ---------------------------------------------------------------
    def node_grads(self, params: PyTree, tokens: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, PyTree]:
        """(loss, grads) of one node at its own ``params`` (no node axis) on
        its own rows; grads in the parameters' dtype. With
        ``cfg.microbatches`` > 1 dividing the rows, the microbatches'
        gradients average in f32, as the reference accumulates them."""
        leaves: List[torch.Tensor] = []

        def leaf(t: torch.Tensor) -> torch.Tensor:
            t = t.detach().requires_grad_(True)
            leaves.append(t)
            return t

        live = tree_map(leaf, params)

        def unflatten(flat):
            it = iter(flat)
            return tree_map(lambda _: next(it), live)

        mb = max(int(self.cfg.microbatches), 1)
        rows = tokens.shape[0]
        if mb > 1 and rows % mb == 0:
            step = rows // mb
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]
            for j in range(mb):
                part = slice(j * step, (j + 1) * step)
                l = self.model.train_loss(live, Batch(tokens=tokens[part], labels=labels[part]))
                g = torch.autograd.grad(l, leaves)
                for a, x in zip(acc, g):
                    a.add_(x.float() / mb)
                loss = loss + l.detach() / mb
            return loss, unflatten([a.to(t.dtype) for a, t in zip(acc, leaves)])
        loss = self.model.train_loss(live, Batch(tokens=tokens, labels=labels))
        return loss.detach(), unflatten(torch.autograd.grad(loss, leaves))

    def grads(self, params: PyTree, batch: Batch) -> Tuple[torch.Tensor, PyTree, List[float]]:
        """(mean loss, mean gradient over nodes, each node's loss): node i at
        its row of ``params`` on rows [i·bpn, (i+1)·bpn) of the batch."""
        n = self.n_nodes
        tokens = batch.tokens.to(self.device)
        labels = batch.labels.to(self.device)
        if tokens.shape[0] % n:
            raise ValueError(f"a batch of {tokens.shape[0]} rows does not split over {n} nodes")
        bpn = tokens.shape[0] // n
        acc, losses = None, []
        for i in range(n):
            rows = slice(i * bpn, (i + 1) * bpn)
            loss, g = self.node_grads(tree_map(lambda t: t[i], params), tokens[rows],
                                      labels[rows])
            if acc is None:
                acc = tree_map(lambda x: x.float(), g)
            else:
                tree_map(lambda a, x: a.add_(x.float()), acc, g)
            losses.append(loss)
            del g
        mean = tree_map(lambda a, p: (a / n).to(p.dtype), acc, params)
        loss = torch.stack(losses).mean()
        return loss, mean, [float(x) for x in losses]

    # -- the step -------------------------------------------------------------
    def gossip(self, params: PyTree, opt_state: Dict[str, PyTree]
               ) -> Tuple[PyTree, Dict[str, PyTree]]:
        """One MOSGU round on the masters (re-cast into the parameters) or,
        without masters, on the parameters."""
        dfl, plan, codec = self.dfl, self.plan, self.codec
        wire = torch.bfloat16 if dfl.wire_dtype == "bfloat16" else None
        ef = opt_state.get("codec_ef")

        def exchange(theta):
            if ef is not None:
                return gossip_exchange(dfl.gossip_mode, plan, theta, codec=codec, ef_state=ef)
            return gossip_exchange(dfl.gossip_mode, plan, theta, wire_dtype=wire,
                                   codec=codec), None

        if "master" in opt_state:
            master, new_ef = exchange(opt_state["master"])
            opt_state = dict(opt_state, master=master)
            params = tree_map(lambda m, p: m.to(p.dtype), master, params)
        else:
            params, new_ef = exchange(params)
        if new_ef is not None:
            opt_state = dict(opt_state, codec_ef=new_ef)
        return params, opt_state

    def train_step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, Any]]:
        """One local step on every node, then (on a gossip step) one round."""
        dev, dfl = self.device, self.dfl
        t0 = _sync(dev) if self.timed else 0.0
        loss, grads, node_losses = self.grads(state.params, batch)
        t1 = _sync(dev) if self.timed else 0.0
        grads, gnorm = clip_by_global_norm(grads, dfl.max_grad_norm)
        ef = state.opt_state.get("codec_ef")
        opt_in = {k: v for k, v in state.opt_state.items() if k != "codec_ef"}
        params, opt_state = self.opt.update(state.params, grads, opt_in, state.step)
        del grads
        if ef is not None:  # optimizers rebuild their state dict; carry the residual
            opt_state = dict(opt_state, codec_ef=ef)
        t2 = _sync(dev) if self.timed else 0.0
        step = int(state.step)
        gossiped = dfl.gossip_interval <= 1 or (step + 1) % dfl.gossip_interval == 0
        if gossiped:
            params, opt_state = self.gossip(params, opt_state)
        t3 = _sync(dev) if self.timed else 0.0
        metrics: Dict[str, Any] = {"loss": loss, "grad_norm": gnorm,
                                   "node_losses": node_losses, "gossip": gossiped}
        if self.timed:
            metrics["times"] = {"fwd_bwd": t1 - t0, "optimizer": t2 - t1, "gossip": t3 - t2}
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), metrics
