"""Communication-plan IR: every protocol authored once as a policy.

The port's copy of ``repro.core.plan`` (numpy). A policy is built over a
dense :class:`~repro_torch.core.graph.Graph` or a sparse
:class:`~repro_torch.core.sparse.CSRGraph` (the sparse planner's member
trees, flooding on a member-induced CSR subgraph). A policy is a small state machine that *emits*
the sends ``(src, dst, payload)`` of a slot and *commits* their delivery
outcomes; every executor interprets that one interface:

=====================================  ====================================
executor                               entry point
=====================================  ====================================
reference slot recorder                :func:`compile_policy` -> :class:`SlotPlan`
counting pass                          :func:`measure_policy`
runtime queue engine (drops, churn)    :class:`repro_torch.core.gossip.GossipEngine`
fluid network simulator                :func:`repro_torch.core.netsim.simulate_policy`
asynchronous event engine              :class:`repro_torch.core.events.AsyncEventEngine`
permutation-step lowering (the card)   :func:`repro_torch.core.schedule.plan_to_perm_steps`
=====================================  ====================================

Slot policies (``sync = "slot"``) alternate ``emit(slot)`` and
``commit(slot, sends, ok)``; ``ok[i]`` False is a transient link failure,
and the dissemination family keeps the failed entry at the head of the
sender's FIFO for retransmission in its next active slot (paper III-D).
Flooding is also event-driven (``sync = "event"``: ``initial_sends`` /
``on_delivered``), as the fluid simulator runs it. A commit returns the
round's *new* :class:`Deliveries` in delivery order.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .graph import Graph
from .sparse import CSRGraph

# A directed send: (src, dst, payload). For dissemination the payload is the
# *payload id* of the model (or model segment) being forwarded; for tree
# plans it is a phase tag (0 = partial sum, 1 = aggregated mean).
Send = Tuple[int, int, int]


# ---------------------------------------------------------------------------
# IR containers
# ---------------------------------------------------------------------------


@dataclass
class Slot:
    """One colored time slot."""

    color: int
    sends: List[Send] = field(default_factory=list)


@dataclass
class SlotPlan:
    """A compiled communication plan (the recorded IR of one round)."""

    n: int
    kind: str  # dissemination | segmented_gossip | tree_allreduce | flooding | ...
    slots: List[Slot]
    colors: np.ndarray  # node colors used for scheduling (-1 = unscheduled)
    # For dissemination-family plans: queue snapshot after each slot, for
    # testing vs the runtime engine / the paper's Table I.
    # queue_trace[t][u] = list of payload ids in node u's FIFO after slot t.
    queue_trace: Optional[List[List[List[int]]]] = None
    # received_trace[t][u] = set of payload ids u holds after slot t.
    received_trace: Optional[List[List[Set[int]]]] = None
    # Fraction of the full model each send carries (1/S for segmented gossip).
    payload_fraction: float = 1.0
    n_reduce_slots: int = 0  # tree plans: slots of the reduce phase

    # -- accounting ---------------------------------------------------------
    @property
    def n_slots(self) -> int:
        return len(self.slots)

    def total_transmissions(self) -> int:
        return sum(len(s.sends) for s in self.slots)

    def max_concurrent_sends(self) -> int:
        return max((len(s.sends) for s in self.slots), default=0)

    def bytes_on_wire(self, model_bytes: float, codec=None) -> float:
        """Total bytes crossing links for one communication round.

        ``codec`` (a :class:`repro_torch.compress.Codec`) makes the accounting
        wire-format aware: each send carries the codec's exact encoding of
        its ``payload_fraction`` share of a ``model_bytes`` fp32 model.
        """
        from ..compress.codec import per_send_wire_bytes

        return self.total_transmissions() * per_send_wire_bytes(
            codec, model_bytes * self.payload_fraction)

    def max_queue_depth(self) -> int:
        if not self.queue_trace:
            return 1
        return max(len(q) for snap in self.queue_trace for q in snap)


@dataclass
class SlotSends:
    """Vectorized emission of one slot: parallel (src, dst, payload) arrays.

    ``senders`` lists the node ids that acted this slot (needed by policies
    whose commit must distinguish "popped my FIFO head" from "sent nothing").
    """

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


@dataclass
class Deliveries:
    """The *new* deliveries produced by a commit, in delivery order."""

    src: np.ndarray
    dst: np.ndarray
    payload: np.ndarray

    def __len__(self) -> int:
        return int(self.src.shape[0])

    @classmethod
    def empty(cls) -> "Deliveries":
        z = np.zeros(0, dtype=np.int64)
        return cls(z, z, z)


# ---------------------------------------------------------------------------
# Policy interface
# ---------------------------------------------------------------------------


class CommPolicy:
    """A communication protocol, authored once, consumed by every executor.

    Subclasses define the protocol state machine; executors only ever call
    the methods below and never look inside.
    """

    kind: str = "abstract"
    sync: str = "slot"  # "slot" (barrier-synchronized) | "event" (reactive)
    trace_queues: bool = False  # expose queue/received snapshots for tracing
    payload_fraction: float = 1.0  # per-send size as a fraction of the model

    n: int = 0
    n_payloads: int = 0
    colors: Optional[np.ndarray] = None
    graph: Optional[Graph] = None  # the graph whose edges the sends traverse

    # -- lifecycle ----------------------------------------------------------
    def reset(self) -> None:
        raise NotImplementedError

    def done(self) -> bool:
        raise NotImplementedError

    # -- slot-synchronous interface -----------------------------------------
    def emit(self, slot_idx: int) -> SlotSends:
        """Propose this slot's sends. Must not mutate policy state."""
        raise NotImplementedError

    def commit(self, slot_idx: int, sends: SlotSends,
               ok: Optional[np.ndarray] = None) -> Deliveries:
        """Apply send outcomes. ``ok[i]`` False = transient link failure; the
        policy decides retransmission semantics. Returns new deliveries."""
        raise NotImplementedError

    # -- event-driven interface (optional) ----------------------------------
    def initial_sends(self) -> List[Send]:
        raise NotImplementedError(f"{self.kind} has no event-driven form")

    def on_delivered(self, src: int, dst: int, payload: int) -> List[Send]:
        raise NotImplementedError(f"{self.kind} has no event-driven form")

    # -- hooks --------------------------------------------------------------
    def initial_payload_ids(self, u: int) -> List[int]:
        """Payload ids node ``u`` holds at round start (its own models)."""
        return []

    def finalize_plan(self, plan: SlotPlan) -> None:
        """Attach protocol-specific annotations to a freshly compiled plan."""

    def queue_snapshot(self) -> List[List[int]]:
        raise NotImplementedError

    def received_snapshot(self) -> List[Set[int]]:
        raise NotImplementedError

    def _plan_colors(self) -> np.ndarray:
        if self.colors is None:
            return -np.ones(self.n, dtype=np.int64)
        return np.asarray(self.colors)


def _color_cycle(colors: np.ndarray, first_color: Optional[int] = None) -> List[int]:
    # np.unique is the vectorized sorted-set — same output as the historical
    # sorted(set(...)), a million-element colors array away from a Python loop
    cycle = [int(c) for c in np.unique(np.asarray(colors))]
    if first_color is not None and first_color in cycle:
        i0 = cycle.index(first_color)
        cycle = cycle[i0:] + cycle[:i0]
    return cycle


def _csr(g: Graph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR adjacency (indptr, indices, degree) with neighbors ascending."""
    if isinstance(g, CSRGraph):
        return (g.indptr.astype(np.int64), g.indices.astype(np.int64),
                g.degrees.astype(np.int64))
    rows, cols = np.nonzero(g.adj > 0)
    deg = np.bincount(rows, minlength=g.n)
    indptr = np.concatenate(([0], np.cumsum(deg)))
    return indptr.astype(np.int64), cols.astype(np.int64), deg.astype(np.int64)


# ---------------------------------------------------------------------------
# MOSGU dissemination (paper III-D) — the vectorized hot path
# ---------------------------------------------------------------------------


class DisseminationPolicy(CommPolicy):
    """The paper's FIFO gossip over the colored MST, ``segments`` models wide.

    Per slot (alternating colors), every node of the active color with a
    non-empty FIFO pops its *oldest* entry and multicasts it to all MST
    neighbours except the one it received it from (its own entries go to all
    neighbours). Degree-1 nodes never enqueue received entries (paper III-D).
    A send whose delivery fails (``ok`` False) keeps the entry at the head of
    the sender's FIFO for retransmission on its next active slot.

    With ``segments > 1`` this is segmented gossip (Hu et al.): each model is
    split into S segments gossiped independently; payload id
    ``owner * S + seg`` identifies one segment. All state lives in
    node-indexed numpy arrays, so a slot advance is O(active sends) vector
    work rather than a per-node Python loop.
    """

    kind = "dissemination"
    trace_queues = True

    def __init__(self, mst: Graph, colors: np.ndarray, first_color: int = 0,
                 segments: int = 1) -> None:
        if not mst.is_connected():
            raise ValueError("gossip requires a connected MST")
        if segments < 1:
            raise ValueError("segments must be >= 1")
        self.graph = mst
        self.n = mst.n
        self.colors = np.asarray(colors)
        self.segments = segments
        self.n_payloads = self.n * segments
        self.color_cycle = _color_cycle(self.colors, first_color)
        self._indptr, self._indices, self._deg = _csr(mst)
        self.reset()

    # -- lifecycle ----------------------------------------------------------
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

    def initial_payload_ids(self, u: int) -> List[int]:
        S = self.segments
        return list(range(u * S, (u + 1) * S))

    def owner_of(self, payload_id: int) -> int:
        return payload_id // self.segments

    # -- slot interface -----------------------------------------------------
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

    def commit(self, slot_idx: int, sends: SlotSends,
               ok: Optional[np.ndarray] = None) -> Deliveries:
        senders = sends.senders if sends.senders is not None else np.unique(sends.src)
        if ok is None or bool(np.all(ok)):
            popped = senders
            s_ok, d_ok, p_ok = sends.src, sends.dst, sends.payload
        else:
            ok = np.asarray(ok, dtype=bool)
            # paper III-D: keep the entry in F if *any* of its transfers failed
            drops_per_node = np.bincount(sends.src[~ok], minlength=self.n)
            popped = senders[drops_per_node[senders] == 0]
            s_ok, d_ok, p_ok = sends.src[ok], sends.dst[ok], sends.payload[ok]
        self._head[popped] += 1
        if s_ok.size == 0:
            return Deliveries.empty()
        # deduplicate against already-received (retransmissions may repeat a
        # delivery; on a failure-free tree this never triggers)
        new = ~self._received[d_ok, p_ok]
        s_n, d_n, p_n = s_ok[new], d_ok[new], p_ok[new]
        if d_n.size > 1:
            key = d_n * self.n_payloads + p_n
            _, first = np.unique(key, return_index=True)
            if first.size != key.size:  # same (dst, payload) twice in a slot
                first = np.sort(first)
                s_n, d_n, p_n = s_n[first], d_n[first], p_n[first]
        if d_n.size == 0:
            return Deliveries.empty()
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
        return Deliveries(s_n, d_n, p_n)

    def _grow_to(self, cap: int) -> None:
        cur = self._fifo_owner.shape[1]
        if cap <= cur:
            return
        new_cap = max(cap, 2 * cur)
        pad = ((0, 0), (0, new_cap - cur))
        self._fifo_owner = np.pad(self._fifo_owner, pad, constant_values=-1)
        self._fifo_pred = np.pad(self._fifo_pred, pad, constant_values=-1)

    # -- inspection ---------------------------------------------------------
    def queue_snapshot(self) -> List[List[int]]:
        return [self._fifo_owner[u, self._head[u]:self._tail[u]].tolist()
                for u in range(self.n)]

    def queue_entries(self, u: int) -> List[Tuple[int, int]]:
        """Node u's FIFO as (payload_id, predecessor) pairs, oldest first."""
        return list(zip(self._fifo_owner[u, self._head[u]:self._tail[u]].tolist(),
                        self._fifo_pred[u, self._head[u]:self._tail[u]].tolist()))

    def received_snapshot(self) -> List[Set[int]]:
        return [set(np.nonzero(self._received[u])[0].tolist())
                for u in range(self.n)]


class SegmentedGossipPolicy(DisseminationPolicy):
    """Segmented gossip (Hu et al.): S independent per-segment gossips.

    Same FIFO/coloring discipline as MOSGU dissemination, but the model is
    split into ``segments`` pieces of size ``1/S`` each; a node transmits one
    segment per slot, pipelining the round: total bytes are unchanged
    (S · N(N-1) transfers of size/S) while per-transfer latency shrinks,
    which the fluid simulator rewards with higher link utilization.
    """

    kind = "segmented_gossip"

    def __init__(self, mst: Graph, colors: np.ndarray, segments: int = 4,
                 first_color: int = 0) -> None:
        super().__init__(mst, colors, first_color=first_color, segments=segments)
        self.payload_fraction = 1.0 / segments

    def finalize_plan(self, plan: SlotPlan) -> None:
        plan.payload_fraction = self.payload_fraction
        plan.n_segments = self.segments  # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# Tree all-reduce (beyond-paper) on the colored MST
# ---------------------------------------------------------------------------


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
    """Reduce partial sums to the root, then broadcast the mean back down.

    Respects the paper's colored slot discipline: a node transmits only in
    slots of its own color. Payload tags: 0 = partial sum (reduce phase),
    1 = aggregated mean (broadcast phase). O(2·depth) slots, O(1) buffers.
    """

    kind = "tree_allreduce"

    def __init__(self, mst: Graph, colors: np.ndarray, root: int = 0) -> None:
        if not mst.is_connected():
            raise ValueError("tree allreduce requires a connected MST")
        self.graph = mst
        self.n = mst.n
        self.colors = np.asarray(colors)
        self.root = root
        self.n_payloads = self.n
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

    def commit(self, slot_idx: int, sends: SlotSends,
               ok: Optional[np.ndarray] = None) -> Deliveries:
        if ok is None:
            ok = np.ones(len(sends), dtype=bool)
        ok = np.asarray(ok, dtype=bool)
        tuples = sends.tuples()
        failed = {s for (s, _, _), o in zip(tuples, ok) if not o}
        delivered = [t for t, o in zip(tuples, ok) if o]
        if self._phase == "reduce":
            for (u, p, _tag) in delivered:
                if u in failed:
                    continue  # single send per reducer; kept for symmetry
                self._sent_up[u] = True
                self._pending_children[p].discard(u)
            if all(self._sent_up.values()):
                self._n_reduce_slots = slot_idx + 1
                self._phase = "broadcast"
        else:
            for (u, v, _tag) in delivered:
                self._has_mean[v] = True
            for u in (sends.senders.tolist() if sends.senders is not None else []):
                if u not in failed and all(self._has_mean[v] for v in self.children[u]):
                    self._forwarded[u] = True
        if not delivered:
            return Deliveries.empty()
        arr = np.asarray(delivered, dtype=np.int64)
        return Deliveries(arr[:, 0], arr[:, 1], arr[:, 2])

    def finalize_plan(self, plan: SlotPlan) -> None:
        plan.n_reduce_slots = self._n_reduce_slots
        plan.parent = self.parent  # type: ignore[attr-defined]
        plan.children = self.children  # type: ignore[attr-defined]
        plan.root = self.root  # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# Flooding baseline (slot-synchronous *and* event-driven interpretations)
# ---------------------------------------------------------------------------


class FloodingPolicy(CommPolicy):
    """Naive flooding on the overlay: forward every new model to every
    neighbour. Duplicate transmissions are counted as real transfers — that
    is the point of the baseline (maximal link contention).

    The forwarding rule is defined once (:meth:`_forward`); the slot
    executors run it rounds-synchronously (one slot per flooding round, as
    the paper's compiled baseline), while the fluid simulator runs it
    event-driven (forward immediately on first receipt). Either way every
    node forwards each model exactly once, so total transmissions agree.
    """

    kind = "flooding"
    sync = "event"

    def __init__(self, overlay: Graph) -> None:
        self.graph = overlay
        self.n = overlay.n
        self.n_payloads = overlay.n
        self.colors = None
        self._neighbors = {u: overlay.neighbors(u) for u in range(overlay.n)}
        self.reset()

    def reset(self) -> None:
        self._received: List[Set[int]] = [{u} for u in range(self.n)]
        self._fresh: List[Set[int]] = [{u} for u in range(self.n)]

    def done(self) -> bool:
        return not any(self._fresh)

    def initial_payload_ids(self, u: int) -> List[int]:
        return [u]

    def _forward(self, u: int, owner: int) -> List[Send]:
        return [(u, v, owner) for v in self._neighbors[u]]

    # -- slot-synchronous (rounds) ------------------------------------------
    def emit(self, slot_idx: int) -> SlotSends:
        sends: List[Send] = []
        for u in range(self.n):
            for owner in sorted(self._fresh[u]):
                sends.extend(self._forward(u, owner))
        return SlotSends.from_tuples(slot_idx, -1, sends)

    def commit(self, slot_idx: int, sends: SlotSends,
               ok: Optional[np.ndarray] = None) -> Deliveries:
        if ok is None:
            ok = np.ones(len(sends), dtype=bool)
        for u in range(self.n):
            self._fresh[u] = set()
        new: List[Send] = []
        for (s, d, owner), o in zip(sends.tuples(), np.asarray(ok, dtype=bool)):
            if o and owner not in self._received[d]:
                self._received[d].add(owner)
                self._fresh[d].add(owner)
                new.append((s, d, owner))
        if not new:
            return Deliveries.empty()
        arr = np.asarray(new, dtype=np.int64)
        return Deliveries(arr[:, 0], arr[:, 1], arr[:, 2])

    # -- event-driven --------------------------------------------------------
    def initial_sends(self) -> List[Send]:
        out: List[Send] = []
        for u in range(self.n):
            out.extend(self._forward(u, u))
        return out

    def on_delivered(self, src: int, dst: int, payload: int) -> List[Send]:
        if payload in self._received[dst]:
            return []
        self._received[dst].add(payload)
        return self._forward(dst, payload)

    def received_snapshot(self) -> List[Set[int]]:
        return [set(r) for r in self._received]


# ---------------------------------------------------------------------------
# Replay + one-shot exchange policies (netsim measurement units)
# ---------------------------------------------------------------------------


class ReplayPolicy(CommPolicy):
    """Replays an already-compiled :class:`SlotPlan` — the IR consumed as-is.

    Lets the fluid simulator (or the queue engine) execute exactly the slots
    a reference compile produced, which is how cross-executor trace
    equivalence is tested.
    """

    def __init__(self, plan: SlotPlan) -> None:
        self.plan = plan
        self.kind = plan.kind
        self.n = plan.n
        self.n_payloads = plan.n
        self.colors = plan.colors
        self.payload_fraction = plan.payload_fraction
        self.reset()

    def reset(self) -> None:
        self._ptr = 0

    def done(self) -> bool:
        return self._ptr >= len(self.plan.slots)

    def emit(self, slot_idx: int) -> SlotSends:
        slot = self.plan.slots[self._ptr]
        return SlotSends.from_tuples(slot_idx, slot.color, slot.sends)

    def commit(self, slot_idx: int, sends: SlotSends,
               ok: Optional[np.ndarray] = None) -> Deliveries:
        self._ptr += 1
        return Deliveries(sends.src, sends.dst, sends.payload)


class BroadcastOncePolicy(CommPolicy):
    """One conventional-broadcast exchange: all N nodes push their model to
    the other N-1 concurrently (the paper's per-round measurement unit for
    the broadcast baseline; overlay is complete, paper IV-B)."""

    kind = "broadcast_exchange"

    def __init__(self, n: int) -> None:
        self.n = n
        self.n_payloads = n
        self.colors = None
        self.reset()

    def reset(self) -> None:
        self._emitted = False

    def done(self) -> bool:
        return self._emitted

    def emit(self, slot_idx: int) -> SlotSends:
        sends = [(u, v, u) for u in range(self.n) for v in range(self.n) if v != u]
        return SlotSends.from_tuples(slot_idx, -1, sends)

    def commit(self, slot_idx: int, sends: SlotSends,
               ok: Optional[np.ndarray] = None) -> Deliveries:
        self._emitted = True
        return Deliveries(sends.src, sends.dst, sends.payload)


class MstExchangePolicy(CommPolicy):
    """One MOSGU exchange step: each node multicasts its *own* model to its
    MST neighbours during its color's slot (the paper's per-round
    measurement unit; full dissemination is :class:`DisseminationPolicy`)."""

    kind = "mosgu_exchange"

    def __init__(self, mst: Graph, colors: np.ndarray) -> None:
        self.graph = mst
        self.n = mst.n
        self.n_payloads = mst.n
        self.colors = np.asarray(colors)
        self.color_cycle = _color_cycle(self.colors)
        self.reset()

    def reset(self) -> None:
        self._ptr = 0

    def done(self) -> bool:
        return self._ptr >= len(self.color_cycle)

    def initial_payload_ids(self, u: int) -> List[int]:
        return [u]

    def emit(self, slot_idx: int) -> SlotSends:
        color = self.color_cycle[self._ptr]
        if isinstance(self.graph, CSRGraph):
            # sparse fast path: the slot's multicast as array gathers, the
            # same sends in the same (u ascending, neighbours ascending)
            # order as the dense loop
            indptr, indices = self.graph.indptr, self.graph.indices
            active = np.flatnonzero(np.asarray(self.colors) == color)
            cnt = indptr[active + 1] - indptr[active]
            total = int(cnt.sum())
            local = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(cnt) - cnt, cnt)
            dst = indices[np.repeat(indptr[active], cnt) + local]
            src = np.repeat(active, cnt)
            return SlotSends(slot_idx, color, src, dst, src.copy(), active)
        sends = [(u, v, u) for u in range(self.n)
                 if int(self.colors[u]) == color
                 for v in self.graph.neighbors(u)]
        return SlotSends.from_tuples(slot_idx, color, sends)

    def commit(self, slot_idx: int, sends: SlotSends,
               ok: Optional[np.ndarray] = None) -> Deliveries:
        self._ptr += 1
        return Deliveries(sends.src, sends.dst, sends.payload)


# ---------------------------------------------------------------------------
# Executors: reference slot recorder + counting fast path
# ---------------------------------------------------------------------------


def compile_policy(policy: CommPolicy, max_slots: int = 100_000) -> SlotPlan:
    """Run a slot policy to completion, recording every slot (and, for the
    dissemination family, its FIFO and received snapshots) — the reference
    executor every other interpreter is tested against."""
    policy.reset()
    slots: List[Slot] = []
    queue_trace: Optional[List[List[List[int]]]] = [] if policy.trace_queues else None
    received_trace: Optional[List[List[Set[int]]]] = [] if policy.trace_queues else None
    t = 0
    while not policy.done():
        if t >= max_slots:
            raise RuntimeError(
                f"{policy.kind} did not converge within {max_slots} slots — "
                "invalid MST/coloring or disconnected overlay?")
        sends = policy.emit(t)
        policy.commit(t, sends)
        slots.append(Slot(color=sends.color, sends=sends.tuples()))
        if queue_trace is not None:
            queue_trace.append(policy.queue_snapshot())
            received_trace.append(policy.received_snapshot())
        t += 1
    plan = SlotPlan(
        n=policy.n,
        kind=policy.kind,
        slots=slots,
        colors=policy._plan_colors(),
        queue_trace=queue_trace,
        received_trace=received_trace,
        payload_fraction=policy.payload_fraction,
    )
    policy.finalize_plan(plan)
    return plan


def measure_policy(policy: CommPolicy, max_slots: int = 1_000_000) -> Dict[str, int]:
    """Run a slot policy to completion counting slots and transmissions
    without materializing Python send tuples (the sweep tables' counting
    pass)."""
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


# ---------------------------------------------------------------------------
# Protocol registry
# ---------------------------------------------------------------------------

PROTOCOL_NAMES = ("dissemination", "mosgu", "segmented", "segmented_gossip",
                  "flooding", "tree_allreduce", "broadcast_exchange",
                  "mosgu_exchange")


def make_policy(
    name: str,
    overlay: Graph,
    mst: Optional[Graph] = None,
    colors: Optional[np.ndarray] = None,
    mst_algorithm: str = "prim",
    coloring_algorithm: str = "bfs",
    first_color: int = 0,
    n_segments: int = 4,
    root: int = 0,
) -> CommPolicy:
    """Build a protocol policy by name over ``overlay``.

    MST-based protocols compute (or accept precomputed) MST + coloring;
    flooding runs on the raw overlay.
    """
    from .graph import build_mst, color_graph  # local import: avoid cycles

    if name == "flooding":
        return FloodingPolicy(overlay)
    if name in ("broadcast", "broadcast_exchange"):
        return BroadcastOncePolicy(overlay.n)
    if mst is None:
        mst = build_mst(overlay, mst_algorithm)
    if colors is None:
        colors = color_graph(mst, coloring_algorithm)
    if name in ("dissemination", "mosgu"):
        return DisseminationPolicy(mst, colors, first_color)
    if name in ("segmented", "segmented_gossip"):
        return SegmentedGossipPolicy(mst, colors, segments=n_segments,
                                     first_color=first_color)
    if name == "tree_allreduce":
        return TreeAllreducePolicy(mst, colors, root)
    if name == "mosgu_exchange":
        return MstExchangePolicy(mst, colors)
    raise ValueError(f"unknown protocol {name!r}; known: {PROTOCOL_NAMES}")
