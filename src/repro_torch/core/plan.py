"""Communication-plan IR: slot policies compiled into a :class:`SlotPlan`.

A trimmed copy of ``repro.core.plan``: the three policies the gossip round
lowers (MOSGU dissemination, segmented gossip, tree all-reduce), the
counting units of the sweep tables (flooding, one broadcast exchange, one
MOSGU exchange), the reference slot recorder :func:`compile_policy`, the
counting pass :func:`measure_policy` and the protocol registry
:func:`make_policy`. A policy emits the sends of one slot and commits their
delivery; the recorder runs it to completion. Queue traces, drops, the
event-driven interface and the other executors are not on the port's path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .graph import Graph

# A directed send: (src, dst, payload). For dissemination the payload is the
# id of the model (or model segment) being forwarded; for tree plans it is a
# phase tag (0 = partial sum, 1 = aggregated mean).
Send = Tuple[int, int, int]


@dataclass
class Slot:
    """One colored time slot."""

    color: int
    sends: List[Send] = field(default_factory=list)


@dataclass
class SlotPlan:
    """A compiled communication plan (the recorded IR of one round)."""

    n: int
    kind: str
    slots: List[Slot]
    colors: np.ndarray  # node colors used for scheduling (-1 = unscheduled)
    payload_fraction: float = 1.0  # per-send share of the model (1/S segmented)
    n_reduce_slots: int = 0  # tree plans: slots of the reduce phase

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def total_transmissions(self) -> int:
        return sum(len(s.sends) for s in self.slots)


@dataclass
class SlotSends:
    """One slot's emission: parallel (src, dst, payload) arrays."""

    slot_idx: int
    color: int
    src: np.ndarray
    dst: np.ndarray
    payload: np.ndarray
    senders: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.src.shape[0])

    def tuples(self) -> List[Send]:
        return list(zip(self.src.tolist(), self.dst.tolist(), self.payload.tolist()))

    @classmethod
    def from_tuples(cls, slot_idx: int, color: int, sends: Sequence[Send],
                    senders: Optional[np.ndarray] = None) -> "SlotSends":
        a = np.asarray(sends, dtype=np.int64).reshape(-1, 3)
        return cls(slot_idx, color, a[:, 0], a[:, 1], a[:, 2], senders)


class CommPolicy:
    """A slot-synchronous protocol: ``emit`` a slot's sends, ``commit`` them."""

    kind: str = "abstract"
    payload_fraction: float = 1.0
    n: int = 0
    colors: Optional[np.ndarray] = None

    def reset(self) -> None:
        raise NotImplementedError

    def done(self) -> bool:
        raise NotImplementedError

    def emit(self, slot_idx: int) -> SlotSends:
        raise NotImplementedError

    def commit(self, slot_idx: int, sends: SlotSends) -> None:
        raise NotImplementedError

    def finalize_plan(self, plan: SlotPlan) -> None:
        """Attach protocol-specific annotations to a freshly compiled plan."""


def _color_cycle(colors: np.ndarray, first_color: Optional[int] = None) -> List[int]:
    """Slot colors in ascending order, rotated to start at ``first_color``
    when it is one of them."""
    cycle = [int(c) for c in np.unique(np.asarray(colors))]
    if first_color is not None and first_color in cycle:
        i0 = cycle.index(first_color)
        cycle = cycle[i0:] + cycle[:i0]
    return cycle


def _csr(g: Graph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR adjacency (indptr, indices, degree) with neighbours ascending."""
    rows, cols = np.nonzero(g.adj > 0)
    deg = np.bincount(rows, minlength=g.n)
    indptr = np.concatenate(([0], np.cumsum(deg)))
    return indptr.astype(np.int64), cols.astype(np.int64), deg.astype(np.int64)


class DisseminationPolicy(CommPolicy):
    """The paper's FIFO gossip over the colored MST (III-D).

    Per slot (alternating colors), every node of the active color with a
    non-empty FIFO pops its oldest entry and multicasts it to all MST
    neighbours except the one it came from. Degree-1 nodes never enqueue
    received entries. With ``segments > 1`` this is segmented gossip:
    payload id ``owner * S + seg`` names one segment.
    """

    kind = "dissemination"

    def __init__(self, mst: Graph, colors: np.ndarray, first_color: int = 0,
                 segments: int = 1) -> None:
        if not mst.is_connected():
            raise ValueError("gossip requires a connected MST")
        if segments < 1:
            raise ValueError("segments must be >= 1")
        self.n = mst.n
        self.colors = np.asarray(colors)
        self.segments = segments
        self.n_payloads = self.n * segments
        self.color_cycle = _color_cycle(self.colors, first_color)
        self._indptr, self._indices, self._deg = _csr(mst)
        self.reset()

    def reset(self) -> None:
        n, S, P = self.n, self.segments, self.n_payloads
        cap = max(4 * S, 16)
        self._fifo_owner = np.full((n, cap), -1, dtype=np.int64)
        self._fifo_pred = np.full((n, cap), -1, dtype=np.int64)
        self._head = np.zeros(n, dtype=np.int64)
        self._tail = np.zeros(n, dtype=np.int64)
        self._received = np.zeros((n, P), dtype=bool)
        own = np.arange(n)[:, None] * S + np.arange(S)[None, :]  # (n, S)
        self._received[np.arange(n)[:, None], own] = True
        self._received_count = np.full(n, S, dtype=np.int64)
        has_nb = self._deg > 0
        self._fifo_owner[has_nb, :S] = own[has_nb]
        self._tail[has_nb] = S

    def done(self) -> bool:
        return bool((self._received_count == self.n_payloads).all()
                    and (self._head == self._tail).all())

    def emit(self, slot_idx: int) -> SlotSends:
        color = self.color_cycle[slot_idx % len(self.color_cycle)]
        active = (self.colors == color) & (self._head < self._tail)
        senders = np.nonzero(active)[0]
        if senders.size == 0:
            z = np.zeros(0, dtype=np.int64)
            return SlotSends(slot_idx, color, z, z, z, senders)
        owner = self._fifo_owner[senders, self._head[senders]]
        pred = self._fifo_pred[senders, self._head[senders]]
        cnt = self._deg[senders]
        total = int(cnt.sum())
        cum = np.cumsum(cnt)
        local = np.arange(total) - np.repeat(cum - cnt, cnt)
        dst = self._indices[np.repeat(self._indptr[senders], cnt) + local]
        src = np.repeat(senders, cnt)
        keep = dst != np.repeat(pred, cnt)
        return SlotSends(slot_idx, color, src[keep], dst[keep],
                         np.repeat(owner, cnt)[keep], senders)

    def commit(self, slot_idx: int, sends: SlotSends) -> None:
        self._head[sends.senders] += 1
        s_ok, d_ok, p_ok = sends.src, sends.dst, sends.payload
        if s_ok.size == 0:
            return
        new = ~self._received[d_ok, p_ok]
        s_n, d_n, p_n = s_ok[new], d_ok[new], p_ok[new]
        if d_n.size > 1:
            key = d_n * self.n_payloads + p_n
            _, first = np.unique(key, return_index=True)
            if first.size != key.size:  # same (dst, payload) twice in a slot
                first = np.sort(first)
                s_n, d_n, p_n = s_n[first], d_n[first], p_n[first]
        if d_n.size == 0:
            return
        self._received[d_n, p_n] = True
        np.add.at(self._received_count, d_n, 1)
        # degree-1 nodes never forward received entries (paper III-D)
        fwd = self._deg[d_n] > 1
        df, pf, sf = d_n[fwd], p_n[fwd], s_n[fwd]
        if df.size:
            order = np.argsort(df, kind="stable")  # keep delivery order per dst
            dfo, pfo, sfo = df[order], pf[order], sf[order]
            grp_new = np.concatenate(([True], dfo[1:] != dfo[:-1]))
            grp_start = np.nonzero(grp_new)[0]
            rank = np.arange(dfo.size) - grp_start[np.cumsum(grp_new) - 1]
            pos = self._tail[dfo] + rank
            self._grow_to(int(pos.max()) + 1)
            self._fifo_owner[dfo, pos] = pfo
            self._fifo_pred[dfo, pos] = sfo
            self._tail += np.bincount(dfo, minlength=self.n)

    def _grow_to(self, cap: int) -> None:
        cur = self._fifo_owner.shape[1]
        if cap <= cur:
            return
        pad = ((0, 0), (0, max(cap, 2 * cur) - cur))
        self._fifo_owner = np.pad(self._fifo_owner, pad, constant_values=-1)
        self._fifo_pred = np.pad(self._fifo_pred, pad, constant_values=-1)


class SegmentedGossipPolicy(DisseminationPolicy):
    """Segmented gossip (Hu et al.): S independent per-segment gossips, each
    send carrying 1/S of the model."""

    kind = "segmented_gossip"

    def __init__(self, mst: Graph, colors: np.ndarray, segments: int = 4,
                 first_color: int = 0) -> None:
        super().__init__(mst, colors, first_color=first_color, segments=segments)
        self.payload_fraction = 1.0 / segments


def tree_structure(mst: Graph, root: int) -> Tuple[Dict[int, int], Dict[int, List[int]], Dict[int, int]]:
    """Return (parent, children, depth) maps of the MST rooted at ``root``."""
    parent: Dict[int, int] = {root: -1}
    children: Dict[int, List[int]] = {u: [] for u in range(mst.n)}
    depth: Dict[int, int] = {root: 0}
    stack = [root]
    while stack:
        u = stack.pop()
        for v in mst.neighbors(u):
            if v not in parent:
                parent[v] = u
                children[u].append(v)
                depth[v] = depth[u] + 1
                stack.append(v)
    return parent, children, depth


class TreeAllreducePolicy(CommPolicy):
    """Reduce partial sums to the root, then broadcast the mean back down,
    each node transmitting only in slots of its own color."""

    kind = "tree_allreduce"

    def __init__(self, mst: Graph, colors: np.ndarray, root: int = 0) -> None:
        if not mst.is_connected():
            raise ValueError("tree allreduce requires a connected MST")
        self.n = mst.n
        self.colors = np.asarray(colors)
        self.root = root
        self.color_cycle = _color_cycle(self.colors)
        self.parent, self.children, _ = tree_structure(mst, root)
        self.reset()

    def reset(self) -> None:
        n = self.n
        self._pending_children = {u: set(self.children[u]) for u in range(n)}
        self._sent_up = {u: False for u in range(n)}
        self._sent_up[self.root] = True  # root never sends up
        self._has_mean = {u: u == self.root for u in range(n)}
        self._forwarded = {u: not self.children[u] for u in range(n)}
        self._n_reduce_slots = 0
        self._phase = "reduce" if not all(self._sent_up.values()) else "broadcast"

    def done(self) -> bool:
        return self._phase == "broadcast" and all(self._forwarded.values())

    def emit(self, slot_idx: int) -> SlotSends:
        color = self.color_cycle[slot_idx % len(self.color_cycle)]
        sends: List[Send] = []
        senders: List[int] = []
        if self._phase == "reduce":
            for u in range(self.n):
                if (u == self.root or self._sent_up[u]
                        or int(self.colors[u]) != color or self._pending_children[u]):
                    continue
                sends.append((u, self.parent[u], 0))
                senders.append(u)
        else:
            for u in range(self.n):
                if (self._forwarded[u] or int(self.colors[u]) != color
                        or not self._has_mean[u]):
                    continue
                for v in self.children[u]:
                    if not self._has_mean[v]:
                        sends.append((u, v, 1))
                senders.append(u)
        return SlotSends.from_tuples(slot_idx, color, sends,
                                     np.asarray(senders, dtype=np.int64))

    def commit(self, slot_idx: int, sends: SlotSends) -> None:
        delivered = sends.tuples()
        if self._phase == "reduce":
            for (u, p, _tag) in delivered:
                self._sent_up[u] = True
                self._pending_children[p].discard(u)
            if all(self._sent_up.values()):
                self._n_reduce_slots = slot_idx + 1
                self._phase = "broadcast"
        else:
            for (_u, v, _tag) in delivered:
                self._has_mean[v] = True
            for u in sends.senders.tolist():
                if all(self._has_mean[v] for v in self.children[u]):
                    self._forwarded[u] = True

    def finalize_plan(self, plan: SlotPlan) -> None:
        plan.n_reduce_slots = self._n_reduce_slots


class FloodingPolicy(CommPolicy):
    """Naive flooding on the overlay, rounds-synchronously (one slot per
    flooding round): every node forwards each model it first received in
    the last round to all its neighbours. Duplicates count as transfers."""

    kind = "flooding"

    def __init__(self, overlay: Graph) -> None:
        self.n = overlay.n
        self.colors = None
        self._neighbors = {u: overlay.neighbors(u) for u in range(overlay.n)}
        self.reset()

    def reset(self) -> None:
        self._received: List[Set[int]] = [{u} for u in range(self.n)]
        self._fresh: List[Set[int]] = [{u} for u in range(self.n)]

    def done(self) -> bool:
        return not any(self._fresh)

    def emit(self, slot_idx: int) -> SlotSends:
        sends = [(u, v, owner) for u in range(self.n) for owner in sorted(self._fresh[u])
                 for v in self._neighbors[u]]
        return SlotSends.from_tuples(slot_idx, -1, sends)

    def commit(self, slot_idx: int, sends: SlotSends) -> None:
        self._fresh = [set() for _ in range(self.n)]
        for _s, d, owner in sends.tuples():
            if owner not in self._received[d]:
                self._received[d].add(owner)
                self._fresh[d].add(owner)


class BroadcastOncePolicy(CommPolicy):
    """One conventional-broadcast exchange: all N nodes push their model to
    the other N-1 at once (the paper's per-round unit for the broadcast
    baseline)."""

    kind = "broadcast_exchange"

    def __init__(self, n: int) -> None:
        self.n = n
        self.colors = None
        self.reset()

    def reset(self) -> None:
        self._emitted = False

    def done(self) -> bool:
        return self._emitted

    def emit(self, slot_idx: int) -> SlotSends:
        sends = [(u, v, u) for u in range(self.n) for v in range(self.n) if v != u]
        return SlotSends.from_tuples(slot_idx, -1, sends)

    def commit(self, slot_idx: int, sends: SlotSends) -> None:
        self._emitted = True


class MstExchangePolicy(CommPolicy):
    """One MOSGU exchange step: each node multicasts its own model to its MST
    neighbours in its color's slot (the paper's per-round unit)."""

    kind = "mosgu_exchange"

    def __init__(self, mst: Graph, colors: np.ndarray) -> None:
        self.graph = mst
        self.n = mst.n
        self.colors = np.asarray(colors)
        self.color_cycle = _color_cycle(self.colors)
        self.reset()

    def reset(self) -> None:
        self._ptr = 0

    def done(self) -> bool:
        return self._ptr >= len(self.color_cycle)

    def emit(self, slot_idx: int) -> SlotSends:
        color = self.color_cycle[self._ptr]
        sends = [(u, v, u) for u in range(self.n) if int(self.colors[u]) == color
                 for v in self.graph.neighbors(u)]
        return SlotSends.from_tuples(slot_idx, color, sends)

    def commit(self, slot_idx: int, sends: SlotSends) -> None:
        self._ptr += 1


def compile_policy(policy: CommPolicy, max_slots: int = 100_000) -> SlotPlan:
    """Run a slot policy to completion, recording every slot."""
    policy.reset()
    slots: List[Slot] = []
    t = 0
    while not policy.done():
        if t >= max_slots:
            raise RuntimeError(
                f"{policy.kind} did not converge within {max_slots} slots — "
                "invalid MST/coloring or disconnected overlay?")
        sends = policy.emit(t)
        policy.commit(t, sends)
        slots.append(Slot(color=sends.color, sends=sends.tuples()))
        t += 1
    colors = (-np.ones(policy.n, dtype=np.int64) if policy.colors is None
              else np.asarray(policy.colors))
    plan = SlotPlan(n=policy.n, kind=policy.kind, slots=slots, colors=colors,
                    payload_fraction=policy.payload_fraction)
    policy.finalize_plan(plan)
    return plan


def measure_policy(policy: CommPolicy, max_slots: int = 1_000_000) -> Dict[str, int]:
    """Run a slot policy to completion counting slots and transmissions,
    without recording the sends (the sweep tables' counting pass)."""
    policy.reset()
    t = transmissions = max_concurrent = 0
    while not policy.done():
        if t >= max_slots:
            raise RuntimeError(f"{policy.kind} did not converge")
        sends = policy.emit(t)
        policy.commit(t, sends)
        k = len(sends)
        transmissions += k
        max_concurrent = max(max_concurrent, k)
        t += 1
    return {"n_slots": t, "transmissions": transmissions,
            "max_concurrent_sends": max_concurrent}


PROTOCOL_NAMES = ("dissemination", "mosgu", "segmented", "segmented_gossip",
                  "flooding", "tree_allreduce", "broadcast_exchange",
                  "mosgu_exchange")


def make_policy(name: str, overlay: Graph, mst_algorithm: str = "prim",
                coloring_algorithm: str = "bfs", first_color: int = 0,
                n_segments: int = 4) -> CommPolicy:
    """A protocol policy by name over ``overlay``: the MST protocols build the
    MST and its coloring; flooding and the broadcast exchange run on the
    overlay itself."""
    from .graph import build_mst, color_graph

    if name == "flooding":
        return FloodingPolicy(overlay)
    if name in ("broadcast", "broadcast_exchange"):
        return BroadcastOncePolicy(overlay.n)
    mst = build_mst(overlay, mst_algorithm)
    colors = color_graph(mst, coloring_algorithm)
    if name in ("dissemination", "mosgu"):
        return DisseminationPolicy(mst, colors, first_color)
    if name in ("segmented", "segmented_gossip"):
        return SegmentedGossipPolicy(mst, colors, segments=n_segments, first_color=first_color)
    if name == "tree_allreduce":
        return TreeAllreducePolicy(mst, colors)
    if name == "mosgu_exchange":
        return MstExchangePolicy(mst, colors)
    raise ValueError(f"unknown protocol {name!r}; known: {PROTOCOL_NAMES}")
