"""MOSGU gossip round on stacked node replicas or between ranks (the port
of ``repro.dfl.collectives``).

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

Between ranks (a plan built by :meth:`GossipPlan.build_mesh` from a
``DeviceMesh`` and the config's node axes, the counterpart of the JAX
package's ``shard_map`` bodies), a rank holds its own local shard of each
leaf and no node axis. Each permutation step runs as point-to-point
transfers (``torch.distributed.batch_isend_irecv``) between the ranks that
hold the same shard on the sending and the receiving node; with a codec the
encoded buffers cross the wire (a group's int8 / int4 arenas, top-k's
values and indices) and the receiver decodes them. Receive buffers start
zero-filled, as a ``ppermute`` target that nothing reaches holds zeros.
Flooding is an all-gather and ``allreduce_ref`` an all-reduce over the node
axes (functional collectives, which an op counter sees). A dispatch mode
does not see point-to-point calls, so each step tells the active counters
its sends and their bytes under the kind :data:`P2P_KIND`, the JAX
roofline's name for the ``collective-permute`` a ``ppermute`` lowers to
(:func:`rank_gossip_bytes` is the same count from the plan).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

import torch.distributed as dist
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

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
# the op counter's kind for the gossip's point-to-point sends (the JAX
# roofline's HLO kind of a ppermute)
P2P_KIND = "collective-permute"

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
class MeshNodes:
    """A rank's place among the DFL nodes of a ``DeviceMesh``: the node axes
    (the config's that the mesh has, in mesh order), this rank's node id
    (row-major over them, the JAX package's ``_node_index``) and, by node
    id, the global rank that holds this rank's coordinates on every other
    axis (its peer on that node)."""

    mesh: Any
    axes: Tuple[str, ...]
    node: int
    ranks: List[int]
    n_pods: int = 1
    _group: Any = field(default=None, repr=False, compare=False)

    @classmethod
    def of(cls, mesh: Any, node_axes: Sequence[str]) -> "MeshNodes":
        names = list(mesh.mesh_dim_names)
        axes = tuple(a for a in names if a in node_axes)
        if [a for a in node_axes if a in names] != list(axes):
            raise ValueError(f"node axes {tuple(node_axes)} out of the mesh's order {names}")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not part of the mesh")
        index = tuple(slice(None) if n in axes else coord[i] for i, n in enumerate(names))
        with unset_fake_temporarily():  # the mesh's rank grid is a real tensor
            grid = np.asarray(mesh.mesh.tolist())
        ranks = [int(r) for r in grid[index].reshape(-1)]
        node = ranks.index(dist.get_rank())
        n_pods = int(mesh.size(names.index("pod"))) if "pod" in axes else 1
        return cls(mesh, axes, node, ranks, n_pods)

    def group(self) -> Any:
        """The node axes' process group, for the functional collectives: a
        mesh dimension, or the node axes flattened into one."""
        if self._group is None:
            names = list(self.mesh.mesh_dim_names)
            if len(self.axes) == 1:
                self._group = (self.mesh, names.index(self.axes[0]))
            else:
                self._group = self.mesh[self.axes]._flatten()
        return self._group


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
    # between ranks: this rank's node on the mesh (None: stacked nodes)
    nodes: Optional[MeshNodes] = None
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

    @classmethod
    def build_mesh(cls, mesh: Any, node_axes: Sequence[str], n_segments: int = 4
                   ) -> "GossipPlan":
        """The plan over the nodes of ``mesh``: ``node_axes`` that the mesh
        has, node ids row-major over them, inter-pod links priced over the
        "pod" axis (``GossipPlan.build(mesh, node_axes)`` of the JAX
        package). Its rounds run between ranks on each rank's shards."""
        nodes = MeshNodes.of(mesh, node_axes)
        plan = cls.build(len(nodes.ranks), n_segments, nodes.n_pods)
        plan.nodes = nodes
        return plan

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


# ---------------------------------------------------------------------------
# gossip between ranks: each rank holds its own shard of every leaf
# ---------------------------------------------------------------------------


def _report_p2p(sends: int, n_bytes: int) -> None:
    """Tell the active op counters (a dispatch mode does not see
    point-to-point calls) that this rank sent ``sends`` buffers of
    ``n_bytes`` in all."""
    for m in _get_current_dispatch_mode_stack():
        if hasattr(m, "count_collective"):
            m.count_collective(P2P_KIND, sends, n_bytes)


def _wire(rows: List[torch.Tensor], codec: Optional[Codec], wire_dtype) -> List[torch.Tensor]:
    """The buffers that cross the wire for a group's payloads (one each
    leaf, no node axis)."""
    if codec is not None:
        return list(codec.encode_group([r[None] for r in rows]))
    return [(r.to(wire_dtype) if wire_dtype is not None else r).contiguous() for r in rows]


def _wire_empty(like: List[torch.Tensor], codec: Optional[Codec], wire_dtype
                ) -> List[torch.Tensor]:
    """Zero-filled receive buffers for :func:`_wire` of payloads shaped as
    ``like`` (zeros, not ``empty``: under a fake process group nothing
    arrives, and a top-k decode of stale indices would write anywhere)."""
    if codec is not None:
        return list(codec.empty_group([t[None] for t in like]))
    return [torch.zeros(t.shape, dtype=wire_dtype or t.dtype, device=t.device) for t in like]


def _unwire(got: List[torch.Tensor], like: List[torch.Tensor], codec: Optional[Codec]
            ) -> List[torch.Tensor]:
    if codec is not None:
        return [d[0] for d in codec.decode_group(tuple(got), [t[None] for t in like])]
    return got


def _mesh_step(plan: GossipPlan, perm: Sequence[Tuple[int, int]],
               send: Callable[[], List[torch.Tensor]], like: List[torch.Tensor],
               codec: Optional[Codec] = None, wire_dtype=None) -> Optional[List[torch.Tensor]]:
    """One permutation step on this rank: the wire form of ``send()`` goes
    to the rank of this node's target in ``perm`` (if any), and what this
    node's source sends arrives, decoded in ``like``'s shapes and dtypes
    (the wire dtype's without a codec). None when no source targets this
    node."""
    nodes = plan.nodes
    me = nodes.node
    dst = next((d for s_, d in perm if s_ == me), None)
    src = next((s_ for s_, d in perm if d == me), None)
    ops: List[Any] = []
    if dst is not None:
        out = _wire(send(), codec, wire_dtype)
        ops += [dist.P2POp(dist.isend, b, nodes.ranks[dst]) for b in out]
        _report_p2p(len(out), sum(b.numel() * b.element_size() for b in out))
    got = None
    if src is not None:
        got = _wire_empty(like, codec, wire_dtype)
        ops += [dist.P2POp(dist.irecv, b, nodes.ranks[src]) for b in got]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return None if got is None else _unwire(got, like, codec)


def _mesh_row(plan: GossipPlan) -> Tuple[int, bool]:
    """This node's buffer row and whether it is a live member."""
    me = plan.nodes.node
    if plan.node_slot is None:
        return me, True
    slot = int(plan.node_slot[me])
    return max(slot, 0), slot >= 0


def _mesh_tree(plan: GossipPlan, theta: PyTree, wire_dtype=None,
               codec: Optional[Codec] = None) -> PyTree:
    """:func:`_tree_allreduce_body` between ranks."""
    if plan.n_nodes == 1:
        return theta
    leaves, rebuild = tree_flatten(theta)
    _, member = _mesh_row(plan)

    def one(group: List[int]) -> List[torch.Tensor]:
        accs = [leaves[i].to(torch.float32, copy=True) for i in group]
        for k, step in enumerate(plan.tree_steps):
            got = _mesh_step(plan, step.perm, lambda: accs, accs, codec, wire_dtype)
            if got is None:
                continue
            if k < plan.n_tree_reduce_steps:
                accs = [a + g.float() for a, g in zip(accs, got)]
            else:
                accs = [g.float() for g in got]
        inv_n = torch.tensor(1.0 / plan.n_nodes, dtype=torch.float32, device=accs[0].device)
        return [(acc * inv_n).to(leaves[i].dtype) if member else leaves[i]
                for i, acc in zip(group, accs)]

    return rebuild(_by_groups(hop_groups("tree_allreduce", plan, leaves, codec), one))


def _mesh_dissemination(plan: GossipPlan, theta: PyTree, codec: Optional[Codec] = None,
                        ef: Optional[PyTree] = None) -> Tuple[PyTree, Optional[PyTree]]:
    """:func:`_dissemination_body` between ranks: this rank's (N, ...)
    buffer of every node's shard, then the mix kernel's mean."""
    if plan.n_nodes == 1:
        return theta, ef
    n, me = plan.n_nodes, plan.nodes.node
    row, member = _mesh_row(plan)
    leaves, rebuild = tree_flatten(theta)
    residuals = tree_flatten(ef)[0] if codec is not None and ef is not None else None

    def one(group: List[int]) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
        ts = [leaves[i] for i in group]
        contrib, new_ef = ts, [None] * len(ts)
        if residuals is not None:
            comp = [t.float() + residuals[i] for i, t in zip(group, ts)]
            dec = [d[0] for d in codec.roundtrip_group([c[None] for c in comp])]
            new_ef = [c - d for c, d in zip(comp, dec)]
            contrib = [d.to(t.dtype) for d, t in zip(dec, ts)]
            del comp, dec
        bufs = []
        for c in contrib:
            buf = torch.zeros((n, *c.shape), dtype=c.dtype, device=c.device)
            buf[row] = c
            bufs.append(buf)
        del contrib
        for step in plan.diss_steps:
            send, recv = int(step.send_payload[me]), int(step.recv_payload[me])
            got = _mesh_step(plan, step.perm, lambda: [b[send] for b in bufs],
                             [b[0] for b in bufs], codec)
            if got is not None:
                for b, g in zip(bufs, got):
                    b[recv] = g.to(b.dtype)
        means = [fedavg_mean(b.reshape(1, n, -1)).reshape(t.shape).to(t.dtype)
                 for t, b in zip(ts, bufs)]
        return [(m if member else t, e) for m, t, e in zip(means, ts, new_ef)]

    out = _by_groups(hop_groups("dissemination", plan, leaves, codec), one)
    return (rebuild([o for o, _ in out]),
            rebuild([e for _, e in out]) if residuals is not None else None)


def _mesh_segmented(plan: GossipPlan, theta: PyTree, codec: Optional[Codec] = None) -> PyTree:
    """:func:`_segmented_body` between ranks."""
    if plan.n_nodes == 1:
        return theta
    n, S, me = plan.n_nodes, plan.n_segments, plan.nodes.node
    row, member = _mesh_row(plan)
    leaves, rebuild = tree_flatten(theta)

    def segments(t: torch.Tensor) -> torch.Tensor:
        flat = t.reshape(-1)
        segs = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % S)).reshape(S, -1)
        buf = torch.zeros((n * S, segs.shape[1]), dtype=t.dtype, device=t.device)
        buf[row * S:(row + 1) * S] = segs
        return buf

    def one(group: List[int]) -> List[torch.Tensor]:
        bufs = [segments(leaves[i]) for i in group]
        for step in plan.seg_steps:
            send, recv = int(step.send_payload[me]), int(step.recv_payload[me])
            got = _mesh_step(plan, step.perm, lambda: [b[send] for b in bufs],
                             [b[0] for b in bufs], codec)
            if got is not None:
                for b, g in zip(bufs, got):
                    b[recv] = g.to(b.dtype)
        out = []
        for i, buf in zip(group, bufs):
            t = leaves[i]
            mean = fedavg_mean(buf.reshape(1, n, -1))[0, :t.numel()].reshape(t.shape)
            out.append(mean.to(t.dtype) if member else t)
        return out

    return rebuild(_by_groups(hop_groups("segmented", plan, leaves, codec), one))


def _mesh_mixing(plan: GossipPlan, theta: PyTree) -> PyTree:
    """:func:`_mixing_body` between ranks: each layer of node-disjoint
    pairs swaps every leaf once."""
    if plan.n_nodes == 1:
        return theta
    leaves, rebuild = tree_flatten(theta)
    for m in plan.mixing_matchings:
        for layer in _disjoint_layers(m):
            perm = [(u, v) for u, v in layer] + [(v, u) for u, v in layer]
            got = _mesh_step(plan, perm, lambda: leaves, leaves)
            if got is not None:
                leaves = [(0.5 * t.float() + 0.5 * g.float()).to(t.dtype)
                          for t, g in zip(leaves, got)]
    return rebuild(leaves)


def _mesh_flooding(plan: GossipPlan, theta: PyTree, codec: Optional[Codec] = None) -> PyTree:
    """:func:`_flooding_body` between ranks: an all-gather over the node
    axes, then the mean."""
    if plan.n_nodes == 1:
        return theta
    import torch.distributed._functional_collectives as funcol

    leaves, rebuild = tree_flatten(theta)
    n_phys = len(plan.nodes.ranks)

    def one(group: List[int]) -> List[torch.Tensor]:
        ts = [leaves[i] for i in group]
        if codec is not None:
            ts = [w[0].to(t.dtype) for w, t in
                  zip(codec.roundtrip_group([t[None] for t in ts]), ts)]
        out = []
        for i, tw in zip(group, ts):
            t = leaves[i]
            allm = funcol.all_gather_tensor(tw.reshape(-1).contiguous(), 0, plan.nodes.group())
            allm = funcol.wait_tensor(allm)
            out.append(fedavg_mean(allm.reshape(1, n_phys, -1)).to(t.dtype).reshape(t.shape))
        return out

    return rebuild(_by_groups(hop_groups("flooding", plan, leaves, codec), one))


def _mesh_allreduce_ref(plan: GossipPlan, theta: PyTree) -> PyTree:
    """:func:`_allreduce_ref_body` between ranks: an f32 all-reduce over the
    node axes (the sum in the backend's order), over n_nodes."""
    if plan.n_nodes == 1:
        return theta
    import torch.distributed._functional_collectives as funcol

    def one(t: torch.Tensor) -> torch.Tensor:
        total = funcol.wait_tensor(funcol.all_reduce(t.float(), "sum", plan.nodes.group()))
        return (total / plan.n_nodes).to(t.dtype)

    return tree_map(one, theta)


def _mesh_exchange(mode: str, plan: GossipPlan, params: PyTree, wire_dtype, codec, ef_state):
    if ef_state is not None:
        return _mesh_dissemination(plan, params, codec=codec, ef=ef_state)
    if mode == "tree_allreduce":
        return _mesh_tree(plan, params, wire_dtype=wire_dtype, codec=codec)
    if mode == "dissemination":
        return _mesh_dissemination(plan, params, codec=codec)[0]
    if mode == "segmented":
        return _mesh_segmented(plan, params, codec=codec)
    if mode == "flooding":
        return _mesh_flooding(plan, params, codec=codec)
    if mode == "mixing":
        return _mesh_mixing(plan, params)
    return _mesh_allreduce_ref(plan, params)


def _wire_nbytes(numel: int, dtype: torch.dtype, codec: Optional[Codec], wire_dtype) -> int:
    """The bytes :func:`_wire` sends for one payload of ``numel`` elements
    in ``dtype``."""
    if codec is None:
        return numel * (wire_dtype or dtype).itemsize
    if codec.grouped:
        from ..kernels.codec.group import group_layout

        layout = group_layout(1, (numel,), codec.bits, codec.chunk)
        return layout.total_chunks * (layout.width + 4)
    return sum(math.prod(shape) * dt.itemsize for shape, dt in codec.wire_shapes((1, numel)))


def rank_gossip_bytes(mode: str, plan: GossipPlan, params: PyTree, wire_dtype=None,
                      codec: Optional[Codec] = None, node: Optional[int] = None) -> float:
    """The bytes one rank of ``node`` (this rank's by default) sends point
    to point in one round of ``mode`` over its shards ``params``: its
    node's transmissions in the plan, each carrying every leaf's wire form
    (a segment of it for segmented gossip; tree hops carry f32 partial
    sums). Flooding and ``allreduce_ref`` send none (they are collectives).
    Summed over every node, with a raw wire, it is
    :func:`gossip_collective_bytes` of the shards' bytes."""
    if plan.n_nodes == 1 or mode in ("flooding", "allreduce_ref"):
        return 0.0
    me = plan.nodes.node if node is None else node
    if codec is not None and getattr(codec, "name", "") == "fp32":
        codec = None
    leaves = tree_flatten(params)[0]
    if mode == "mixing":
        sends = sum(any(me in pair for pair in layer) for m in plan.mixing_matchings
                    for layer in _disjoint_layers(m))
        return float(sends * sum(_wire_nbytes(t.numel(), t.dtype, None, None) for t in leaves))
    steps = {"dissemination": plan.diss_steps, "segmented": plan.seg_steps,
             "tree_allreduce": plan.tree_steps}[mode]
    sends = sum(any(s_ == me for s_, _ in step.perm) for step in steps)
    if mode == "tree_allreduce":
        per = sum(_wire_nbytes(t.numel(), torch.float32, codec, wire_dtype) for t in leaves)
    elif mode == "segmented":
        per = sum(_wire_nbytes(-(-t.numel() // plan.n_segments), t.dtype, codec, None)
                  for t in leaves)
    else:
        per = sum(_wire_nbytes(t.numel(), t.dtype, codec, None) for t in leaves)
    return float(sends * per)


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
    """Apply one MOSGU communication round to stacked ``(N, ...)`` params,
    or, with a plan from :meth:`GossipPlan.build_mesh`, to this rank's
    shards (no node axis) between ranks.

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
    if plan.nodes is not None:
        return _mesh_exchange(mode, plan, params, wire_dtype, codec, ef_state)
    if ef_state is not None:
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
