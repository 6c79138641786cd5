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

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from .. import DeviceLike, resolve_device
from ..compress import make_codec
from ..models.layers import cross_entropy_loss
from ..models.model import MOE_AUX_WEIGHT, Batch, Model
from ..optim.optimizers import Optimizer, clip_by_global_norm, make_optimizer, tree_leaves
from .collectives import GossipPlan, gossip_exchange, tree_flatten, tree_map
from .sharding import batch_axes, batch_spec, distribute_tree, param_spec_tree, placements

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


# ---------------------------------------------------------------------------
# the trainer on a mesh
# ---------------------------------------------------------------------------


def _local(tree: PyTree) -> PyTree:
    """Each DTensor leaf's local shard (anything else as it is)."""
    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t, tree)


def _like(local: torch.Tensor, ref: DTensor) -> DTensor:
    """``local`` as a DTensor placed and shaped as ``ref``."""
    return DTensor.from_local(local, ref.device_mesh, ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride())


def _zeros_as(ref: DTensor, dtype: torch.dtype) -> DTensor:
    return _like(torch.zeros(ref.to_local().shape, dtype=dtype, device=ref.to_local().device),
                 ref)


def _factor_state(p: DTensor) -> Dict[str, DTensor]:
    """Adafactor's state of one leaf as DTensors: ``vr`` (the leaf without
    its last dim) and ``vc`` (without the one before), each split where the
    leaf is on the dimensions it keeps."""
    mesh, nd, local = p.device_mesh, p.dim(), p.to_local()

    def drop(dim: int) -> DTensor:
        pl = []
        for q in p.placements:
            if isinstance(q, Shard) and q.dim == dim:
                pl.append(Replicate())
            elif isinstance(q, Shard) and q.dim > dim:
                pl.append(Shard(q.dim - 1))
            else:
                pl.append(q)
        shape = tuple(p.shape[:dim]) + tuple(p.shape[dim + 1:])
        lshape = tuple(local.shape[:dim]) + tuple(local.shape[dim + 1:])
        z = torch.zeros(lshape, dtype=torch.float32, device=local.device)
        return DTensor.from_local(z, mesh, pl, run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))

    if nd >= 2:
        return {"vr": drop(nd - 1), "vc": drop(nd - 2)}
    return {"v": _zeros_as(p, torch.float32)}


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.insert(0, n)
        n *= size
    return tuple(stride)


class MeshDFLTrainer(DFLTrainer):
    """The DFL step on a ``DeviceMesh`` (the JAX trainer's ``mesh`` form):
    one rank of one node, which holds its own shard of every leaf.

    State. Parameters, fp32 masters, the moments and the codec's residual
    are DTensors placed by ``param_spec_tree``: split over "model", experts
    over ``cfg.expert_axis``, replicated over the node axes (a rank's
    shards are made directly, ``dfl/sharding.py::local_param_tree``, or
    split from whole tensors, :meth:`state_from_params`).

    Step. ``train_loss`` over each of ``cfg.microbatches`` contiguous
    slices of the global batch (each split over the batch axes by
    ``batch_spec``), the gradients averaged in f32 (one slice: in the
    parameters' dtype), as the reference's scan accumulates them; a moe
    model's aux loss is the slice's, over every rank's rows. DTensor reduces
    a replicated leaf's gradient over the ranks that hold the batch: every
    node applies the same clipped mean gradient (R9), and the moments stay
    equal across nodes. ``clip_by_global_norm``'s norm sums each leaf's
    squares over the ranks that split it. The optimizer's elementwise passes
    run on the local shards (Adafactor's factored means on the DTensors,
    since they reduce over split dimensions), then gossip runs between
    ranks (:meth:`GossipPlan.build_mesh`) on the local shards of the masters
    (re-cast into the parameters) or of the parameters. A lossy wire leaves
    the replicas along the node axes unequal, as the reference's
    ``shard_map`` does; nothing broadcasts them back.

    The layers run as the meshed prefill does: the residual stream split
    along the sequence over "model" between sublayers (Megatron's sequence
    parallelism, the JAX model's ``act_sharding``), gathered ahead of the
    projections and reduce-scattered after the row-parallel ones by explicit
    autograd Functions on local shards (``models/layers.py``), so no
    sequence-split tensor is flattened to rows; the logits stay split by
    vocabulary into the vocab-parallel cross-entropy. The forward and
    backward run under ``implicit_replication``: a plain constant a layer
    makes (a mask, a padding) is whole on every rank."""

    def __init__(self, model: Model, mesh: Any, dfl: Optional[DFLConfig] = None,
                 optimizer: Optional[Optimizer] = None, timed: bool = False):
        self.mesh = mesh
        plan = GossipPlan.build_mesh(mesh, model.cfg.node_axes)
        dev = model.device
        if dev.type != mesh.device_type:
            raise ValueError(f"the model runs on {dev}, the mesh on {mesh.device_type}")
        super().__init__(model, plan.n_nodes, dfl, optimizer, device=dev, timed=timed)
        self.plan = plan
        self.factored = self.opt.name == "adafactor"

    # -- init -----------------------------------------------------------------
    def init_state(self, gen: torch.Generator) -> TrainState:
        """Every node from one whole ``Model.init`` draw, split: the stacked
        trainer's values (a full-size model makes each rank's shards
        directly instead, ``dfl/sharding.py::local_param_tree``)."""
        return self.state_from_params(self.model.init(gen))

    def state_from_params(self, params: PyTree) -> TrainState:
        """The state of every node starting from ``params``: whole tensors
        (split by the spec tree, each rank keeping its shard) or DTensors."""
        leaves = tree_flatten(params)[0]
        if not all(isinstance(t, DTensor) for t in leaves):
            params = distribute_tree(self.mesh, params, param_spec_tree(self.cfg, params,
                                                                        self.mesh))
        local = _local(params)
        opt_state = self.opt.init(local)
        if self.factored:
            opt_state = {"f": tree_map(_factor_state, params)}
        else:
            opt_state = {k: tree_map(_like, v, params) for k, v in opt_state.items()}
        if self.error_feedback:
            opt_state["codec_ef"] = tree_map(lambda p: _zeros_as(p, torch.float32), params)
        return TrainState(params=params, opt_state=opt_state,
                          step=torch.zeros((), dtype=torch.int32, device=self.device))

    # -- gradients ---------------------------------------------------------------
    def shard_batch(self, batch: Batch) -> Batch:
        """A global batch (whole tensors on every rank) as DTensors split
        over the batch axes (each rank keeps its rows; nothing moves)."""
        def split(t: torch.Tensor) -> DTensor:
            t = t.to(self.device)
            spec = batch_spec(self.mesh, t.shape[0], t.dim())
            return distribute_tensor(t, self.mesh, placements(self.mesh, spec),
                                     src_data_rank=None)

        return _map_batch(split, batch)

    def mesh_grads(self, params: PyTree, batch: Batch
                   ) -> Tuple[torch.Tensor, List[torch.Tensor], List[DTensor]]:
        """(the step's loss, each leaf's local gradient, the leaves): the
        reference's microbatched ``value_and_grad`` of ``train_loss`` over
        the global batch, each gradient reduced to its leaf's placements."""
        g_rows = batch.tokens.shape[0]
        mb = self._slices(g_rows)
        rows = g_rows // mb
        leaves, rebuild = tree_flatten(params)
        acc: Optional[List[torch.Tensor]] = None
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        self.model.set_mesh_context(self.mesh, batch_axes(self.mesh, rows))
        try:
            for j in range(mb):
                part = self.shard_batch(_map_batch(lambda t: t[j * rows:(j + 1) * rows], batch))
                live = [t.detach().requires_grad_(True) for t in leaves]
                with implicit_replication():  # a plain constant (a mask, a pad) is whole
                    l = self.model.train_loss(rebuild(live), part)
                    g = torch.autograd.grad(l, live)
                g = [x.redistribute(self.mesh, p.placements).to_local()
                     for x, p in zip(g, leaves)]
                l = l.detach().full_tensor() if isinstance(l, DTensor) else l.detach()
                if mb == 1:
                    acc, loss = list(g), l.float()
                    break
                if acc is None:
                    acc = [x.float() / mb for x in g]
                else:
                    for a, x in zip(acc, g):
                        a.add_(x.float() / mb)
                loss = loss + l.float() / mb
                del g, live, part
        finally:
            self.model.set_mesh_context(None)
        grads = [a.to(p.dtype) for a, p in zip(acc, leaves)]
        return loss, grads, leaves

    def clip(self, grads: List[torch.Tensor], leaves: List[DTensor], rebuild
             ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """``clip_by_global_norm`` of local gradients: each leaf's f32 sum of
        squares summed over the ranks that split it, in the leaves' order."""
        sqs = []
        for g, p in zip(grads, leaves):
            sq = torch.sum(torch.square(g.float()))
            split = [Partial() if isinstance(q, Shard) else Replicate() for q in p.placements]
            if any(isinstance(q, Partial) for q in split):
                sq = DTensor.from_local(sq, self.mesh, split, run_check=False).full_tensor()
            sqs.append(sq)
        total = None
        for sq in tree_leaves(rebuild(sqs)):  # jax.tree.leaves order
            total = sq if total is None else total + sq
        norm = torch.sqrt(total)
        scale = torch.clamp(self.dfl.max_grad_norm / torch.clamp(norm, min=1e-9), max=1.0)
        return [(g.float() * scale).to(g.dtype) for g in grads], norm

    # -- the step -------------------------------------------------------------
    def train_step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, Any]]:
        """One step of this rank on the global ``batch`` (whole tensors, the
        same on every rank), then (on a gossip step) one round between
        ranks."""
        dev, dfl = self.device, self.dfl
        t0 = _sync(dev) if self.timed else 0.0
        loss, grads, leaves = self.mesh_grads(state.params, batch)
        t1 = _sync(dev) if self.timed else 0.0
        rebuild = tree_flatten(state.params)[1]
        grads, gnorm = self.clip(grads, leaves, rebuild)
        ef = state.opt_state.get("codec_ef")
        opt_in = {k: v for k, v in state.opt_state.items() if k != "codec_ef"}
        if self.factored:  # the factored means reduce over split dimensions
            dgrads = rebuild([_like(g, p) for g, p in zip(grads, leaves)])
            params, opt_state = self.opt.update(state.params, dgrads, opt_in, state.step)
            params = tree_map(lambda n, p: n.redistribute(self.mesh, p.placements).to_local(),
                              params, state.params)
            del dgrads
        else:
            params, opt_state = self.opt.update(_local(state.params), rebuild(grads),
                                                _local(opt_in), state.step)
        del grads, opt_in
        state.params, state.opt_state = None, None
        if ef is not None:
            opt_state = dict(opt_state, codec_ef=_local(ef))
        t2 = _sync(dev) if self.timed else 0.0
        gossiped = (dfl.gossip_interval <= 1
                    or (int(state.step) + 1) % dfl.gossip_interval == 0)
        if gossiped:
            params, opt_state = self.gossip(params, opt_state)
        t3 = _sync(dev) if self.timed else 0.0
        like = rebuild(leaves)
        params = tree_map(_like, params, like)
        opt_state = {k: v if self.factored and k == "f" else tree_map(_like, v, like)
                     for k, v in opt_state.items()}
        metrics: Dict[str, Any] = {"loss": loss, "grad_norm": gnorm, "node_losses": [loss],
                                   "gossip": gossiped}
        if self.timed:
            metrics["times"] = {"fwd_bwd": t1 - t0, "optimizer": t2 - t1, "gossip": t3 - t2}
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), metrics
