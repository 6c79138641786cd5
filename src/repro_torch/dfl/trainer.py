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
   order; the frontend inputs, whisper's ``encoder_frames`` and
   paligemma's ``patch_embeddings``, split by the same rows as the tokens,
   as the reference splits every field of its batch), with
   ``cfg.microbatches`` accumulated in f32 within those rows;
2. the step's loss and gradient are the reference's: the global batch's
   cross-entropy over its count of labels >= 0 (per microbatch slice of the
   global batch, then averaged over the slices), so node i weighs by its
   share of the valid labels, 1 / N only when the nodes hold equal counts
   (P4); the gradient accumulates in f32, then in the parameters' dtype, as
   the reference's gradients are. A moe model's aux loss is the reference's
   too, taken over each slice of the global batch (whichever nodes hold its
   rows), not over each node's rows: a routing pass first counts every
   part's top-k choices without a graph (see :meth:`DFLTrainer.grads`);
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
from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import DeviceLike, resolve_device
from ..compress import make_codec
from ..models.layers import cross_entropy_loss
from ..models.model import MOE_AUX_WEIGHT, Batch, Model
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


def recast(master: PyTree, params: PyTree) -> PyTree:
    """The parameters re-cast from the masters, as a gossip round leaves
    them: an f32 leaf is its master itself (``to`` returns it), so the two
    share one storage."""
    return tree_map(lambda m, p: m.to(p.dtype), master, params)


def _map_batch(fn, batch: Batch) -> Batch:
    """``fn`` of every field of ``batch`` that is set."""
    return Batch(**{f.name: None if getattr(batch, f.name) is None
                    else fn(getattr(batch, f.name)) for f in fields(batch)})


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


class DFLTrainer:
    """One DFL step on ``n_nodes`` stacked replicas. With ``timed`` the step
    synchronizes the device between its phases and reports each phase's
    seconds by host clock in ``metrics["times"]``. A step consumes its input
    state, as the reference's jitted step donates it (``donate_argnums=(0,)``):
    once the optimizer has read them, the input ``TrainState``'s params and
    opt_state are set to None, so the old and new states do not both live
    through the gossip round (the caller must not read a stepped state
    again)."""

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
    def _own_parts(self, rows: int) -> List[Tuple[slice, float]]:
        """A node's rows alone: ``cfg.microbatches`` equal parts of weight
        1 / mb where they divide the rows, else one part of weight 1."""
        mb = max(int(self.cfg.microbatches), 1)
        if mb > 1 and rows % mb == 0:
            step = rows // mb
            return [(slice(j * step, (j + 1) * step), 1.0 / mb) for j in range(mb)]
        return [(slice(0, rows), 1.0)]

    def _weighted_grads(self, params: PyTree, batch: Batch,
                        parts: List[Tuple[slice, Any, Optional[torch.Tensor]]],
                        acc: Optional[List[torch.Tensor]]
                        ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor], PyTree,
                                   List[torch.Tensor]]:
        """Each part (rows, w, coef) of the batch's rows at ``params`` (no node
        axis) adds its objective's gradient in f32 into ``acc`` (one tensor a
        leaf, made when None). Without ``coef`` the objective is w
        ``train_loss`` (differentiated, then scaled by w); with ``coef``, an
        (n_layers, n_experts) tensor, it is w CE + sum coef * P, P the
        layers' router probabilities summed over the part's tokens (the
        part's share of the global aux loss). Returns the objectives' sum,
        the rows' own mean ``train_loss`` (each part's weighted by its count
        of labels >= 0), ``acc``, the live tree that maps it back and, for
        the parts with ``coef``, their (n_layers, n_experts) f counts."""
        leaves: List[torch.Tensor] = []

        def leaf(t: torch.Tensor) -> torch.Tensor:
            t = t.detach().requires_grad_(True)
            leaves.append(t)
            return t

        live = tree_map(leaf, params)
        zero = torch.zeros((), dtype=torch.float32, device=batch.tokens.device)
        loss, own, count, f_counts = zero, zero, zero, []
        for rows, w, coef in parts:
            part = _map_batch(lambda t: t[rows], batch)
            lab = part.labels
            if coef is None:
                l = self.model.train_loss(live, part)
                g = torch.autograd.grad(l, leaves)
                objective, scale = l.detach() * w, w
            else:
                stats: List[Any] = []
                logits, aux = self.model.forward(live, part, stats)
                ce = cross_entropy_loss(logits, lab)
                del logits
                objective = ce * w + (coef * torch.stack([st.p for st in stats])).sum()
                g = torch.autograd.grad(objective, leaves)
                l = ce + MOE_AUX_WEIGHT * aux
                objective, scale = objective.detach(), None
                f_counts.append(torch.stack([st.f for st in stats]))
            if acc is None:  # (the gradients are ours: scaled in place)
                acc = [x.float() if scale is None else x.float().mul_(scale) for x in g]
            else:
                for a, x in zip(acc, g):
                    a.add_(x.float() if scale is None else x.float().mul_(scale))
            del g
            c = (lab >= 0).sum()
            loss = loss + objective
            own = own + l.detach() * c
            count = count + c
        return loss, own / count.clamp(min=1), acc, live, f_counts

    def node_grads(self, params: PyTree, batch: Batch) -> Tuple[torch.Tensor, PyTree]:
        """(loss, grads) of one node at its own ``params`` (no node axis) on
        its own rows ``batch``; grads in the parameters' dtype. With
        ``cfg.microbatches`` > 1 dividing the rows, the microbatches'
        gradients average in f32, as the reference accumulates them."""
        parts = [(rows, w, None) for rows, w in self._own_parts(batch.tokens.shape[0])]
        loss, _, acc, live, _ = self._weighted_grads(params, batch, parts, None)
        it = iter(acc)
        return loss, tree_map(lambda t: next(it).to(t.dtype), live)

    def row_weights(self, labels: torch.Tensor) -> torch.Tensor:
        """(G,) f32 on the labels' device: the weight of each global row's
        summed cross-entropy in the reference's loss (P4). The reference
        splits the global batch into ``mb`` contiguous slices where
        ``cfg.microbatches`` = mb > 1 divides its G rows (else one slice),
        takes each slice's CE over its own count C_j of labels >= 0, and
        averages the slices: a row of slice j weighs 1 / (mb max(C_j, 1))."""
        g_rows = labels.shape[0]
        mb = self._slices(g_rows)
        counts = (labels >= 0).reshape(mb, -1).sum(dim=1).float()
        return (1.0 / (mb * counts.clamp(min=1.0))).repeat_interleave(g_rows // mb)

    def _slices(self, g_rows: int) -> int:
        mb = max(int(self.cfg.microbatches), 1)
        return mb if mb > 1 and g_rows % mb == 0 else 1

    def _node_parts(self, i: int, bpn: int, g_rows: int) -> List[slice]:
        """Node i's rows (global indices), cut where a reference slice ends
        and, where ``cfg.microbatches`` divides ``bpn``, into the node's own
        microbatches (which then lie inside one slice each)."""
        lo, hi = i * bpn, (i + 1) * bpn
        cuts = {lo, hi}
        mb = self._slices(g_rows)
        if mb > 1:
            cuts |= {r for r in range(0, g_rows, g_rows // mb) if lo < r < hi}
            if bpn % mb == 0:
                cuts |= set(range(lo, hi, bpn // mb))
        cuts = sorted(cuts)
        return [slice(a, b) for a, b in zip(cuts[:-1], cuts[1:])]

    def aux_coefs(self, params: PyTree, tokens: torch.Tensor
                  ) -> Tuple[List[List[torch.Tensor]], List[List[torch.Tensor]]]:
        """The routing pass of a moe step. The reference's aux loss of
        microbatch slice j is e sum_l,e f_l,e P_l,e / (k L) with f and P the
        means over the slice's T_j tokens, whichever nodes hold them; f
        carries no gradient, so the aux splits exactly over the parts p of a
        slice. Part p's share of the step's loss is sum_l,e coef_l,e Psum_p,
        with Psum_p its tokens' router probabilities summed and coef =
        0.01 e F_j / (mb L k T_j^2), F_j the slice's f counts: known only
        once every part of the slice is routed. So each node first routes
        its parts under ``no_grad`` (:meth:`Model.route_counts`, no logits).
        Returns each node's per-part coef and per-part f counts, the parts
        of :meth:`_node_parts`."""
        cfg = self.cfg
        g_rows, seq = tokens.shape
        n = self.n_nodes
        node_parts = [self._node_parts(i, g_rows // n, g_rows) for i in range(n)]
        mb = self._slices(g_rows)
        slice_rows = g_rows // mb
        counts = [[self.model.route_counts(tree_map(lambda t: t[i], params), tokens[rows])
                   for rows in parts] for i, parts in enumerate(node_parts)]
        per_slice: List[Any] = [0.0] * mb
        for parts, cs in zip(node_parts, counts):
            for rows, c in zip(parts, cs):
                per_slice[rows.start // slice_rows] = per_slice[rows.start // slice_rows] + c
        scale = (MOE_AUX_WEIGHT * cfg.n_experts
                 / (mb * cfg.n_layers * cfg.top_k * float(slice_rows * seq) ** 2))
        coefs = [[per_slice[rows.start // slice_rows] * scale for rows in parts]
                 for parts in node_parts]
        return coefs, counts

    def grads(self, params: PyTree, batch: Batch
              ) -> Tuple[torch.Tensor, PyTree, List[torch.Tensor], Optional[torch.Tensor]]:
        """(the step's loss, its gradient, each node's own mean loss (a
        device scalar: the step reads nothing back to the host), the route
        mismatch): node i at its row of ``params`` on rows [i·bpn, (i+1)·bpn)
        of the batch.

        The reference differentiates the global batch's masked-mean loss, so
        node i's share weighs by its count of valid labels, not 1 / N (P4):
        each part of its rows (see :meth:`_node_parts`) takes the weight
        c_p / (mb max(C_j, 1)) of :meth:`row_weights`, c_p the part's count
        of labels >= 0. The weights stay on the device; with equal counts
        they are 1 / (N mb), the plain mean over nodes. A moe model adds
        each part's share of its slice's aux loss (:meth:`aux_coefs`); the
        routing pass and the differentiated one must route alike: the route
        mismatch is the sum of |their f counts' differences| over every part
        and layer, a device tensor that is 0 when they do (None for a model
        without experts). A node's own loss is its rows' own ``train_loss``,
        aux over its rows alone."""
        n = self.n_nodes
        batch = _map_batch(lambda t: t.to(self.device), batch)
        tokens, labels = batch.tokens, batch.labels
        g_rows = tokens.shape[0]
        if g_rows % n:
            raise ValueError(f"a batch of {g_rows} rows does not split over {n} nodes")
        bpn = g_rows // n
        row_w = self.row_weights(labels) * (labels >= 0).sum(dim=1)
        node_parts = [self._node_parts(i, bpn, g_rows) for i in range(n)]
        coefs, routed = None, None
        if self.cfg.family == "moe":
            coefs, routed = self.aux_coefs(params, tokens)
        acc, loss, losses, mismatch = None, None, [], None
        for i in range(n):
            parts = [(rows, row_w[rows].sum(), None if coefs is None else coefs[i][j])
                     for j, rows in enumerate(node_parts[i])]
            l, own, acc, _, f_counts = self._weighted_grads(
                tree_map(lambda t: t[i], params), batch, parts, acc)
            loss = l if loss is None else loss + l
            losses.append(own)
            for f, f_routed in zip(f_counts, routed[i] if routed else []):
                d = (f - f_routed).abs().sum()
                mismatch = d if mismatch is None else mismatch + d
        it = iter(acc)
        mean = tree_map(lambda p: next(it).to(p.dtype), params)
        return loss, mean, losses, mismatch

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
            params = recast(master, params)
        else:
            params, new_ef = exchange(params)
        if new_ef is not None:
            opt_state = dict(opt_state, codec_ef=new_ef)
        return params, opt_state

    def train_step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, Any]]:
        """One local step on every node, then (on a gossip step) one round.
        With a gossip interval of 1 the step reads nothing back to the host:
        its metrics are device tensors (``node_losses`` one a node)."""
        dev, dfl = self.device, self.dfl
        t0 = _sync(dev) if self.timed else 0.0
        loss, grads, node_losses, mismatch = self.grads(state.params, batch)
        t1 = _sync(dev) if self.timed else 0.0
        grads, gnorm = clip_by_global_norm(grads, dfl.max_grad_norm)
        ef = state.opt_state.get("codec_ef")
        opt_in = {k: v for k, v in state.opt_state.items() if k != "codec_ef"}
        params, opt_state = self.opt.update(state.params, grads, opt_in, state.step)
        del grads, opt_in
        state.params, state.opt_state = None, None
        if ef is not None:  # optimizers rebuild their state dict; carry the residual
            opt_state = dict(opt_state, codec_ef=ef)
        t2 = _sync(dev) if self.timed else 0.0
        # the host reads the step count only where the interval needs it
        gossiped = (dfl.gossip_interval <= 1
                    or (int(state.step) + 1) % dfl.gossip_interval == 0)
        if gossiped:
            params, opt_state = self.gossip(params, opt_state)
        t3 = _sync(dev) if self.timed else 0.0
        metrics: Dict[str, Any] = {"loss": loss, "grad_norm": gnorm,
                                   "node_losses": node_losses, "gossip": gossiped}
        if mismatch is not None:
            metrics["route_mismatch"] = mismatch
        if self.timed:
            metrics["times"] = {"fwd_bwd": t1 - t0, "optimizer": t2 - t1, "gossip": t3 - t2}
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), metrics
