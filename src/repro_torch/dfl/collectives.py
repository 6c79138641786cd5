"""MOSGU gossip round on stacked node replicas (the port of
``repro.dfl.collectives``).

All N node replicas of a parameter leaf sit in one tensor with a leading
node axis, ``(N, ...)``, on one device. The moderator's slot plan (MST + BFS
2-coloring, :mod:`repro_torch.core`) is lowered to permutation steps; each
:class:`~repro_torch.core.schedule.PermStep` becomes one gather of the sent
payloads along the node axis, their wire round trip (encode on the sender,
decode on receipt), and one masked write into the receivers' rows. A node
that no permutation targets receives nothing, as a ``ppermute`` target
would receive zeros.

Modes (as in the JAX package):
  * dissemination  — every node ends holding all N models in an (N, …)
                     buffer, then takes the FedAvg mean (the mix kernel).
  * segmented      — each model split into S flat segments gossiped
                     independently; N·S segment slots, then the mean.
  * tree_allreduce — reduce partial sums up the colored MST, broadcast the
                     mean down; f32 accumulation in tree order.
  * mixing         — one pairwise-averaging pass over MST edge matchings.
  * flooding       — every node gets every model (all-gather), then mean.
  * allreduce_ref  — the centralized all-reduce reference.

The buffers are updated in place where that saves memory (the perm steps
write into the dissemination buffer); the caller's tensors are never
written. With a codec that decodes several leaves at once (the quantizers),
a body hops a group of leaves at a time (:func:`hop_groups`): each step
encodes every leaf of the group and decodes them in one call
(:meth:`Codec.roundtrip_group`), with the same values as leaf by leaf.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compress.codec import Codec, per_send_wire_mb
from ..core.graph import Graph, build_mst, color_graph
from ..core.plan import SegmentedGossipPolicy, SlotPlan, compile_policy
from ..core.schedule import (
    PermStep,
    compile_dissemination,
    compile_tree_allreduce,
    decompose_matchings,
    plan_to_perm_steps,
)
from ..kernels.mixing.ops import fedavg_mean

PyTree = Any

# A group's round buffers sum to at most this; a larger leaf hops alone.
# A launch's fixed cost matters below a few million elements, far under it.
GROUP_BYTES = 1 << 30


def tree_map(fn: Callable, *trees):
    """Map over nested dict / list / tuple trees of tensors."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *[t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def tree_flatten(tree: PyTree) -> Tuple[List[torch.Tensor], Callable[[Sequence], PyTree]]:
    """The leaves in :func:`tree_map`'s order, and the function that builds
    the same tree from new leaves."""
    leaves: List[torch.Tensor] = []
    tree_map(leaves.append, tree)

    def rebuild(new: Sequence) -> PyTree:
        it = iter(new)
        return tree_map(lambda _: next(it), tree)

    return leaves, rebuild


def make_node_graph(n_nodes: int, n_pods: int = 1, inter_pod_cost: float = 10.0,
                    intra_pod_cost: float = 1.0) -> Graph:
    """Complete cost graph over DFL nodes (``make_node_graph`` of the JAX
    package, with the node and pod counts in place of a mesh).

    Links between pods model the paper's router hop; a tiny deterministic
    jitter makes the MST and coloring unique.
    """
    n = int(n_nodes)
    pod_size = n // n_pods if n_pods > 1 else 1
    adj = np.zeros((n, n))
    for u in range(n):
        for v in range(u + 1, n):
            same_pod = (u // pod_size) == (v // pod_size) if pod_size > 1 else True
            base = intra_pod_cost if same_pod else inter_pod_cost
            adj[u, v] = adj[v, u] = base + 1e-3 * ((u * 31 + v * 17) % 97) / 97.0
    return Graph(adj)


@dataclass
class GossipPlan:
    """Everything the gossip round needs, all static."""

    n_nodes: int  # live nodes: the FedAvg denominator and buffer-row count
    mst: Graph
    colors: np.ndarray
    dissemination: SlotPlan
    tree: SlotPlan
    diss_steps: List[PermStep]
    tree_steps: List[PermStep]
    n_tree_reduce_steps: int
    mixing_matchings: List[List[Tuple[int, int]]]
    segmented: Optional[SlotPlan] = None
    seg_steps: List[PermStep] = field(default_factory=list)
    n_segments: int = 1
    # physical node id -> buffer row (plan payload owner id); None = identity.
    # Under churn the plans index payloads by subgraph row (-1 = masked out).
    node_slot: Optional[np.ndarray] = None
    # physical node count (the node axis); equals n_nodes without churn
    phys_n_nodes: int = 0
    _index_cache: Dict[Any, Any] = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self) -> None:
        if not self.phys_n_nodes:
            self.phys_n_nodes = self.n_nodes

    @classmethod
    def build(cls, n_nodes: int, n_segments: int = 4, n_pods: int = 1) -> "GossipPlan":
        g = make_node_graph(n_nodes, n_pods)
        mst = build_mst(g, "prim")
        colors = color_graph(mst, "bfs")
        diss = compile_dissemination(mst, colors)
        tree = compile_tree_allreduce(mst, colors)
        seg = compile_policy(SegmentedGossipPolicy(mst, colors, segments=n_segments)
                             ) if g.n > 1 else None
        return cls(
            n_nodes=g.n,
            mst=mst,
            colors=colors,
            dissemination=diss,
            tree=tree,
            diss_steps=plan_to_perm_steps(diss),
            tree_steps=plan_to_perm_steps(tree),
            n_tree_reduce_steps=reduce_step_count(tree),
            mixing_matchings=mixing_matchings(mst),
            segmented=seg,
            seg_steps=plan_to_perm_steps(seg) if seg is not None else [],
            n_segments=n_segments,
        )

    def step_index(self, steps: List[PermStep], device: torch.device
                   ) -> List[Tuple[torch.Tensor, ...]]:
        """Per step, (src, send slot, dst, recv slot) index tensors on
        ``device``, built once per plan and device."""
        key = (id(steps), str(device))
        if key not in self._index_cache:
            out = []
            for step in steps:
                src = [s for s, _ in step.perm]
                dst = [d for _, d in step.perm]
                cols = (src, [int(step.send_payload[s]) for s in src],
                        dst, [int(step.recv_payload[d]) for d in dst])
                out.append(tuple(torch.tensor(c, dtype=torch.long, device=device)
                                 for c in cols))
            self._index_cache[key] = out
        return self._index_cache[key]

    def prepare(self, device: torch.device) -> None:
        """Build every step's index tensors on ``device`` ahead of a round."""
        for steps in (self.diss_steps, self.tree_steps, self.seg_steps):
            self.step_index(steps, device)

    def member_mask(self, device: torch.device) -> Optional[torch.Tensor]:
        """(N,) bool of live nodes under churn masking; None = all live."""
        if not (np.asarray(self.colors) < 0).any():
            return None
        return torch.as_tensor(np.asarray(self.colors) >= 0, device=device)

    def buffer_rows(self, device: torch.device) -> torch.Tensor:
        """Each physical node's buffer row (its payload owner id); masked
        nodes get row 0, which nothing reads."""
        if self.node_slot is None:
            return torch.arange(self.phys_n_nodes, device=device)
        return torch.as_tensor(np.maximum(self.node_slot, 0), dtype=torch.long,
                               device=device)


def reduce_step_count(tree: SlotPlan) -> int:
    """Permutation steps belonging to the tree plan's reduce phase."""
    return sum(len([m for m in decompose_matchings(s.sends) if m])
               for s in tree.slots[:tree.n_reduce_slots])


def mixing_matchings(mst: Graph) -> List[List[Tuple[int, int]]]:
    return [[(u, v) for u, v, _ in m]
            for m in decompose_matchings([(u, v, 0) for u, v, _ in mst.edges()])]


# ---------------------------------------------------------------------------
# the wire and the permutation steps
# ---------------------------------------------------------------------------


def hop_groups(mode: str, plan: "GossipPlan", leaves: Sequence[torch.Tensor],
               codec: Optional[Codec]) -> List[List[int]]:
    """The groups of leaf indices that ``mode``'s body hops together.

    Without a codec that decodes a group at once (:attr:`Codec.grouped`)
    each leaf hops alone. With one, consecutive leaves form a group while
    the round buffers they keep alive together (dissemination and
    segmented: ``(N, n, ...)`` in the leaf's dtype; tree and flooding:
    ``(N, ...)`` in f32) sum to at most :data:`GROUP_BYTES`.
    """
    if codec is None or not codec.grouped:
        return [[i] for i in range(len(leaves))]
    copies = plan.n_nodes if mode in ("dissemination", "segmented") else 1
    groups: List[List[int]] = []
    total = 0
    for i, t in enumerate(leaves):
        nbytes = t.numel() * copies * (t.element_size() if copies > 1 else 4)
        if not groups or total + nbytes > GROUP_BYTES:
            groups.append([])
            total = 0
        groups[-1].append(i)
        total += nbytes
    return groups


def _hop(rows: List[torch.Tensor], codec: Optional[Codec], wire_dtype=None
         ) -> List[torch.Tensor]:
    """What the receivers get for each leaf's sent ``rows``: the codec's
    round trip of the group (encode per row, decode on receipt) or the
    wire-dtype cast."""
    if codec is not None:
        return codec.roundtrip_group(rows)
    if wire_dtype is not None:
        return [r.to(wire_dtype) for r in rows]
    return rows


def _apply_perm_steps(plan: GossipPlan, steps: List[PermStep], bufs: List[torch.Tensor],
                      codec: Optional[Codec] = None) -> None:
    """Run a plan's steps over a group's ``(N, slots, ...)`` buffers, in place.

    Each step gathers every sent payload before any write, so a node may
    send one slot and receive another in the same matching. With a codec
    every hop re-encodes (exact for every shipped codec after the first
    encode), one launch encodes all of the step's senders of a leaf, and one
    decode serves the group.
    """
    for src, send, dst, recv in plan.step_index(steps, bufs[0].device):
        got = _hop([buf[src, send] for buf in bufs], codec)
        for buf, g in zip(bufs, got):
            buf[dst, recv] = g.to(buf.dtype)


def _by_groups(groups: List[List[int]], one: Callable[[List[int]], list]) -> list:
    """Each leaf's result of ``one`` on its group, in leaf order. A group's
    buffers live inside ``one`` and are freed when it returns, before the
    next group's are made."""
    out: list = [None] * sum(len(g) for g in groups)
    for group in groups:
        for i, result in zip(group, one(group)):
            out[i] = result
    return out


# ---------------------------------------------------------------------------
# gossip bodies
# ---------------------------------------------------------------------------


def _keep_masked(plan: GossipPlan, out: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Masked nodes (outside the healthy subgraph) keep their own params."""
    mask = plan.member_mask(theta.device)
    if mask is None:
        return out
    return torch.where(mask.view(-1, *([1] * (theta.dim() - 1))), out, theta)


def _tree_allreduce_body(plan: GossipPlan, theta: PyTree, wire_dtype=None,
                         codec: Optional[Codec] = None) -> PyTree:
    """Colored-MST reduce + broadcast; the FedAvg mean on every live node.

    Partial sums accumulate in f32; each hop carries the wire form (the
    ``wire_dtype`` cast or the codec's encoded buffers) of the sender's
    partial sum.
    """
    if plan.n_nodes == 1:
        return theta
    leaves, rebuild = tree_flatten(theta)

    def one(group: List[int]) -> List[torch.Tensor]:
        accs = [leaves[i].to(torch.float32, copy=True) for i in group]
        steps = plan.step_index(plan.tree_steps, accs[0].device)
        for src, _, dst, _ in steps[:plan.n_tree_reduce_steps]:
            got = _hop([acc[src] for acc in accs], codec, wire_dtype)
            for acc, g in zip(accs, got):
                acc[dst] = acc[dst] + g.float()
        for src, _, dst, _ in steps[plan.n_tree_reduce_steps:]:
            got = _hop([acc[src] for acc in accs], codec, wire_dtype)
            for acc, g in zip(accs, got):
                acc[dst] = g.float()
        # the mean as XLA lowers the JAX package's ``acc / n``: a multiply by
        # the f32 reciprocal (identical for power-of-two n)
        inv_n = torch.tensor(1.0 / plan.n_nodes, dtype=torch.float32, device=accs[0].device)
        return [_keep_masked(plan, (acc * inv_n).to(leaves[i].dtype), leaves[i])
                for i, acc in zip(group, accs)]

    return rebuild(_by_groups(hop_groups("tree_allreduce", plan, leaves, codec), one))


def _dissemination_body(plan: GossipPlan, theta: PyTree, codec: Optional[Codec] = None,
                        ef: Optional[PyTree] = None
                        ) -> Tuple[PyTree, Optional[PyTree]]:
    """Paper-faithful full dissemination: (fedavg_mean, new_ef).

    ``ef`` (f32 residuals mirroring ``theta``) enables error feedback: each
    node contributes ``decode(encode(theta + ef))`` and keeps the leftovers
    as the next residual.
    """
    if plan.n_nodes == 1:
        return theta, ef
    n = plan.n_nodes
    leaves, rebuild = tree_flatten(theta)
    residuals = tree_flatten(ef)[0] if codec is not None and ef is not None else None

    def one(group: List[int]) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
        ts = [leaves[i] for i in group]
        contrib, new_ef = ts, [None] * len(ts)
        if residuals is not None:
            comp = [t.float() + residuals[i] for i, t in zip(group, ts)]
            dec = codec.roundtrip_group(comp)
            new_ef = [c - d for c, d in zip(comp, dec)]
            contrib = [d.to(t.dtype) for d, t in zip(dec, ts)]
            del comp, dec
        bufs = []
        for c in contrib:
            nodes = torch.arange(c.shape[0], device=c.device)
            buf = torch.zeros((c.shape[0], n, *c.shape[1:]), dtype=c.dtype, device=c.device)
            buf[nodes, plan.buffer_rows(c.device)] = c
            bufs.append(buf)
        del contrib, buf
        _apply_perm_steps(plan, plan.diss_steps, bufs, codec)
        means = [fedavg_mean(buf.reshape(t.shape[0], n, -1)).reshape(t.shape).to(t.dtype)
                 for t, buf in zip(ts, bufs)]
        return [(_keep_masked(plan, m, t), e) for m, t, e in zip(means, ts, new_ef)]

    out = _by_groups(hop_groups("dissemination", plan, leaves, codec), one)
    return (rebuild([o for o, _ in out]),
            rebuild([e for _, e in out]) if residuals is not None else None)


def _segmented_body(plan: GossipPlan, theta: PyTree, codec: Optional[Codec] = None) -> PyTree:
    """Segmented gossip: each leaf split into S flat segments; the buffer
    holds N·S segment slots (slot k = owner k // S, segment k % S)."""
    if plan.n_nodes == 1:
        return theta
    n, S = plan.n_nodes, plan.n_segments
    leaves, rebuild = tree_flatten(theta)

    def segments(t: torch.Tensor) -> torch.Tensor:
        """(N, ...) -> the (N, n·S, L) buffer, each live node's S segments
        in its own slots."""
        N = t.shape[0]
        flat = t.reshape(N, -1)
        segs = torch.nn.functional.pad(flat, (0, (-flat.shape[1]) % S)).reshape(N, S, -1)
        buf = torch.zeros((N, n * S, segs.shape[2]), dtype=t.dtype, device=t.device)
        slots = plan.buffer_rows(t.device)[:, None] * S + torch.arange(S, device=t.device)
        buf[torch.arange(N, device=t.device)[:, None], slots] = segs
        return buf

    def one(group: List[int]) -> List[torch.Tensor]:
        bufs = [segments(leaves[i]) for i in group]
        _apply_perm_steps(plan, plan.seg_steps, bufs, codec)
        out = []
        for i, buf in zip(group, bufs):
            t = leaves[i]
            models = buf.reshape(t.shape[0], n, -1)  # (N, n, S·L); the padded tail is zero
            mean = fedavg_mean(models)[:, :t[0].numel()].reshape(t.shape).to(t.dtype)
            out.append(_keep_masked(plan, mean, t))
        return out

    return rebuild(_by_groups(hop_groups("segmented", plan, leaves, codec), one))


def _disjoint_layers(matching: List[Tuple[int, int]]) -> List[List[Tuple[int, int]]]:
    """Split a matching of directed MST edges into layers whose pairs share
    no node (greedily, in order). A matching from
    :func:`decompose_matchings` has distinct sources and distinct targets,
    but a node may be the target of one edge and the source of the next;
    pairwise averaging needs node-disjoint pairs. A matching that already is
    node-disjoint stays one layer."""
    layers: List[List[Tuple[int, int]]] = []
    rest = list(matching)
    while rest:
        used: set = set()
        layer, later = [], []
        for u, v in rest:
            if u in used or v in used:
                later.append((u, v))
            else:
                layer.append((u, v))
                used.update((u, v))
        layers.append(layer)
        rest = later
    return layers


def _mixing_body(plan: GossipPlan, theta: PyTree) -> PyTree:
    """One pairwise-averaging pass over the MST edge matchings: each matched
    pair moves to the mean of the two; unmatched and masked nodes keep their
    params."""
    if plan.n_nodes == 1:
        return theta
    layers = [layer for m in plan.mixing_matchings for layer in _disjoint_layers(m)]

    def one(t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        for layer in layers:
            u = torch.tensor([a for a, _ in layer] + [b for _, b in layer],
                             dtype=torch.long, device=t.device)
            v = torch.tensor([b for _, b in layer] + [a for a, _ in layer],
                             dtype=torch.long, device=t.device)
            mixed = 0.5 * t[u].float() + 0.5 * t[v].float()
            t[u] = mixed.to(t.dtype)
        return t

    return tree_map(one, theta)


def _flooding_body(plan: GossipPlan, theta: PyTree, codec: Optional[Codec] = None) -> PyTree:
    """Baseline: every node gets every model (all-gather), then the mean.
    With a codec the gathered values are the decode(encode(·)) round trip."""
    if plan.n_nodes == 1:
        return theta

    leaves, rebuild = tree_flatten(theta)

    def one(group: List[int]) -> List[torch.Tensor]:
        ts = [leaves[i] for i in group]
        if codec is not None:
            ts = [w.to(t.dtype) for w, t in zip(codec.roundtrip_group(ts), ts)]
        out = []
        for i, tw in zip(group, ts):
            t = leaves[i]
            mean = fedavg_mean(tw.reshape(1, t.shape[0], -1)).to(t.dtype)
            out.append(mean.reshape(t.shape[1:]).expand_as(t).clone())
        return out

    return rebuild(_by_groups(hop_groups("flooding", plan, leaves, codec), one))


def _allreduce_ref_body(plan: GossipPlan, theta: PyTree) -> PyTree:
    """Reference all-reduce: the f32 sum over the node axis / n_nodes."""
    if plan.n_nodes == 1:
        return theta

    def one(t: torch.Tensor) -> torch.Tensor:
        total = t.float().sum(dim=0) / plan.n_nodes
        return total.to(t.dtype).expand_as(t).clone()

    return tree_map(one, theta)


GOSSIP_BODIES: Dict[str, Callable] = {
    "tree_allreduce": _tree_allreduce_body,
    "dissemination": lambda plan, theta: _dissemination_body(plan, theta)[0],
    "segmented": _segmented_body,
    "mixing": _mixing_body,
    "flooding": _flooding_body,
    "allreduce_ref": _allreduce_ref_body,
}

# modes whose wire a payload codec can encode (per-hop or pre-gather)
CODEC_MODES = ("dissemination", "segmented", "tree_allreduce", "flooding")


def gossip_exchange(mode: str, plan: GossipPlan, params: PyTree, wire_dtype=None,
                    codec: Optional[Codec] = None, ef_state: Optional[PyTree] = None):
    """Apply one MOSGU communication round to stacked ``(N, ...)`` params.

    ``codec`` puts each hop's encoded buffers on the wire instead of raw
    tensors. ``ef_state`` — f32 residuals mirroring ``params`` — enables
    error feedback (dissemination only); the call then returns
    ``(out, new_ef_state)``.
    """
    if mode not in GOSSIP_BODIES:
        raise ValueError(f"unknown gossip mode {mode!r}; known: {sorted(GOSSIP_BODIES)}")
    if codec is not None and getattr(codec, "name", "") == "fp32":
        codec = None  # identity: the plain wire
    if codec is not None and mode not in CODEC_MODES:
        raise ValueError(
            f"gossip mode {mode!r} does not support a payload codec; "
            f"codec-capable modes: {CODEC_MODES}")
    if ef_state is not None:
        if codec is None:
            raise ValueError("ef_state needs a (lossy) payload codec")
        if mode != "dissemination":
            raise ValueError("error feedback is supported for the "
                             "dissemination mode only")
        return _dissemination_body(plan, params, codec=codec, ef=ef_state)
    if mode == "tree_allreduce":
        return _tree_allreduce_body(plan, params, wire_dtype=wire_dtype, codec=codec)
    if mode == "dissemination":
        return _dissemination_body(plan, params, codec=codec)[0]
    if mode in ("segmented", "flooding"):
        return GOSSIP_BODIES[mode](plan, params, codec=codec)
    return GOSSIP_BODIES[mode](plan, params)


def gossip_collective_bytes(mode: str, plan: GossipPlan, param_bytes: float,
                            codec: Optional[Codec] = None) -> float:
    """Analytic bytes-on-wire per round (whole network, one direction), with
    the codec's exact per-send encoding (:func:`per_send_wire_mb`)."""
    if plan.n_nodes == 1:
        return 0.0

    def total(transmissions: int, fraction: float = 1.0) -> float:
        return transmissions * per_send_wire_mb(
            codec, param_bytes / 1e6, fraction) * 1e6

    if mode == "dissemination":
        return total(plan.dissemination.total_transmissions())
    if mode == "segmented":
        if plan.segmented is None:
            return total(plan.dissemination.total_transmissions())
        return total(plan.segmented.total_transmissions(),
                     plan.segmented.payload_fraction)
    if mode == "tree_allreduce":
        return total(plan.tree.total_transmissions())
    if mode == "mixing":
        return total(2 * len(plan.mst.edges()))
    if mode == "flooding":
        return total(plan.n_nodes * (plan.n_nodes - 1))
    if mode == "allreduce_ref":
        return total(2 * (plan.n_nodes - 1))
    raise ValueError(mode)
