"""Static invariant checkers over the communication-plan IR.

Every checker analyzes a *frozen* plan — per-slot ``(color, src, dst,
payload)`` arrays captured from one policy walk or an already-compiled
:class:`~repro_torch.core.plan.SlotPlan` — and never executes a simulator. A
violation raises :class:`VerificationError` carrying the machine-readable
invariant class name; a clean pass is summarized in a :class:`Certificate`
listing exactly which invariants were proven and which were skipped (and
why), so "verified" is always an auditable claim rather than a boolean.

Invariant classes (the names ``VerificationError.invariant`` carries):

==============================  ============================================
``structure/node-range``        src/dst in ``[0, n)``, ``src != dst``,
                                payload in ``[0, n_payloads)``
``structure/edges-in-graph``    every send traverses a declared graph edge
``schedule/half-duplex``        no vertex both sends and receives inside one
                                colored slot
``schedule/color-discipline``   every sender in a colored slot has the
                                slot's color
``schedule/proper-coloring``    endpoint colors differ on every *used* edge
                                (the scheduled conflict graph is properly
                                colored)
``schedule/degree-cap``         no duplicate directed link use per slot; a
                                node's per-slot sends never exceed its
                                degree
``capacity/admissible``         every send's physical route resolves on the
                                :class:`~repro_torch.core.network.CompiledNetwork`
                                with positive access/trunk/per-flow capacity
``progress/causal-possession``  a sender holds a payload when it forwards it
                                (abstract interpretation over the
                                payload-possession lattice)
``progress/completeness``       every payload reaches every live member
                                within the plan's slots (per-segment
                                certificates for segmented gossip; exact
                                edge-cover certificates for the exchange
                                protocols; reduce/broadcast phase proof for
                                tree allreduce)
``staleness/window-negative``   ``max_staleness >= 0``
``staleness/admission-acyclic`` the bounded-staleness admission graph is a
                                DAG (no round waits on itself)
``conservation/bytes-on-wire``  bytes recomputed from the plan + codec wire
                                model agree exactly with the plan's and the
                                executors' accounting
==============================  ============================================
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.plan import CommPolicy, SlotPlan, _csr

#: above this many (node, payload) lattice cells the dense possession
#: matrix is not materialized and dissemination-family progress checks are
#: recorded as skipped (no registry scenario reaches this — scale-tier
#: scenarios use the exchange protocols, which have exact sparse checks)
MAX_LATTICE_CELLS = 64_000_000

#: every invariant class a certificate may list, in check order
INVARIANT_CLASSES = (
    "structure/node-range",
    "structure/edges-in-graph",
    "schedule/half-duplex",
    "schedule/color-discipline",
    "schedule/proper-coloring",
    "schedule/degree-cap",
    "capacity/admissible",
    "progress/causal-possession",
    "progress/completeness",
    "staleness/window-negative",
    "staleness/admission-acyclic",
    "conservation/bytes-on-wire",
)


class VerificationError(ValueError):
    """A plan violated a static invariant. ``invariant`` names the class."""

    def __init__(self, invariant: str, message: str,
                 details: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(f"[{invariant}] {message}")
        self.invariant = invariant
        self.details = details or {}


@dataclass
class SlotRecord:
    """One slot of a frozen plan, as parallel numpy arrays."""

    color: int
    src: np.ndarray
    dst: np.ndarray
    payload: np.ndarray

    def __len__(self) -> int:
        return int(self.src.shape[0])


@dataclass
class PlanFacts:
    """Everything the checkers need, captured once, executor-independent."""

    n: int
    kind: str
    slots: List[SlotRecord]
    colors: Optional[np.ndarray]
    payload_fraction: float
    n_payloads: int
    segments: int = 1
    graph: Any = None  # Graph | CSRGraph | None
    tree_parent: Optional[Dict[int, int]] = None
    tree_root: Optional[int] = None

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    @property
    def transmissions(self) -> int:
        return sum(len(s) for s in self.slots)

    @classmethod
    def from_policy(cls, policy: CommPolicy) -> "PlanFacts":
        """Freeze a live policy with one emit/commit walk (arrays are
        copied, never round-tripped through Python tuples — this is what
        keeps verification feasible at the 100k/1M exchange scale)."""
        policy.reset()
        slots: List[SlotRecord] = []
        t = 0
        while not policy.done():
            sends = policy.emit(t)
            policy.commit(t, sends)
            slots.append(SlotRecord(
                int(sends.color),
                np.asarray(sends.src, dtype=np.int64).copy(),
                np.asarray(sends.dst, dtype=np.int64).copy(),
                np.asarray(sends.payload, dtype=np.int64).copy()))
            t += 1
        policy.reset()  # hand the (cache-shared) policy back clean
        colors = None if policy.colors is None else np.asarray(policy.colors)
        return cls(
            n=policy.n, kind=policy.kind, slots=slots, colors=colors,
            payload_fraction=policy.payload_fraction,
            n_payloads=policy.n_payloads,
            segments=int(getattr(policy, "segments", 1)),
            graph=policy.graph,
            tree_parent=getattr(policy, "parent", None),
            tree_root=getattr(policy, "root", None))

    @classmethod
    def from_plan(cls, plan: SlotPlan, graph: Any = None) -> "PlanFacts":
        """Facts from a compiled :class:`SlotPlan`. ``graph`` restores the
        edge universe a compiled plan no longer carries; without it the
        graph-dependent checks are recorded as skipped."""
        slots: List[SlotRecord] = []
        for slot in plan.slots:
            arr = np.asarray(slot.sends, dtype=np.int64).reshape(-1, 3)
            slots.append(SlotRecord(int(slot.color), arr[:, 0].copy(),
                                    arr[:, 1].copy(), arr[:, 2].copy()))
        colors = np.asarray(plan.colors) if plan.colors is not None else None
        if colors is not None and (colors < 0).all():
            colors = None  # compiled uncolored plan (flooding/broadcast)
        segments = int(getattr(plan, "n_segments", 1))
        return cls(
            n=plan.n, kind=plan.kind, slots=slots, colors=colors,
            payload_fraction=plan.payload_fraction,
            n_payloads=plan.n * segments, segments=segments, graph=graph,
            tree_parent=getattr(plan, "parent", None),
            tree_root=getattr(plan, "root", None))


@dataclass
class Certificate:
    """What was proven about one plan (and what was not, with reasons)."""

    kind: str
    n: int
    n_slots: int
    transmissions: int
    invariants: List[str] = field(default_factory=list)
    skipped: Dict[str, str] = field(default_factory=dict)
    completion_slot: Optional[int] = None  # when the last payload landed
    # segmented gossip: per-segment dissemination-complete slot index
    segment_completion: Optional[Dict[int, int]] = None
    wire_mb: Optional[float] = None  # statically recomputed bytes on wire
    max_link_flows: Optional[int] = None  # peak per-link slot concurrency

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "kind": self.kind, "n": self.n, "n_slots": self.n_slots,
            "transmissions": self.transmissions,
            "invariants": list(self.invariants),
            "skipped": dict(self.skipped),
        }
        for k in ("completion_slot", "wire_mb", "max_link_flows"):
            if getattr(self, k) is not None:
                d[k] = getattr(self, k)
        if self.segment_completion is not None:
            d["segment_completion"] = {
                str(k): v for k, v in self.segment_completion.items()}
        return d


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------


def check_node_range(facts: PlanFacts) -> None:
    n, P = facts.n, max(facts.n_payloads, 1)
    for t, rec in enumerate(facts.slots):
        if len(rec) == 0:
            continue
        for name, arr, hi in (("src", rec.src, n), ("dst", rec.dst, n),
                              ("payload", rec.payload, P)):
            bad = (arr < 0) | (arr >= hi)
            if bad.any():
                i = int(np.flatnonzero(bad)[0])
                raise VerificationError(
                    "structure/node-range",
                    f"slot {t} send #{i}: {name}={int(arr[i])} outside "
                    f"[0, {hi})", {"slot": t, "index": i})
        loop = rec.src == rec.dst
        if loop.any():
            i = int(np.flatnonzero(loop)[0])
            raise VerificationError(
                "structure/node-range",
                f"slot {t} send #{i}: self-send {int(rec.src[i])} -> "
                f"{int(rec.dst[i])}", {"slot": t, "index": i})


def _edge_keys(graph, n: int) -> np.ndarray:
    """Sorted int64 keys ``src * n + dst`` of every directed edge."""
    indptr, indices, deg = _csr(graph)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    return np.sort(rows * n + indices)


def check_edges_in_graph(facts: PlanFacts) -> None:
    ekeys = _edge_keys(facts.graph, facts.n)
    n = np.int64(facts.n)
    for t, rec in enumerate(facts.slots):
        if len(rec) == 0:
            continue
        skey = rec.src * n + rec.dst
        pos = np.searchsorted(ekeys, skey)
        pos = np.minimum(pos, ekeys.size - 1)
        bad = ekeys.size == 0 or (ekeys[pos] != skey)
        if np.any(bad):
            i = int(np.flatnonzero(bad)[0])
            raise VerificationError(
                "structure/edges-in-graph",
                f"slot {t} send {int(rec.src[i])} -> {int(rec.dst[i])} "
                f"traverses no edge of the scheduled graph",
                {"slot": t, "index": i})


# ---------------------------------------------------------------------------
# schedule safety
# ---------------------------------------------------------------------------


def check_half_duplex(facts: PlanFacts) -> None:
    for t, rec in enumerate(facts.slots):
        if rec.color < 0 or len(rec) == 0:
            continue  # uncolored slots (flooding rounds) carry no discipline
        both = np.intersect1d(rec.src, rec.dst)
        if both.size:
            raise VerificationError(
                "schedule/half-duplex",
                f"slot {t} (color {rec.color}): node {int(both[0])} both "
                f"sends and receives", {"slot": t, "node": int(both[0])})


def check_color_discipline(facts: PlanFacts) -> None:
    colors = facts.colors
    for t, rec in enumerate(facts.slots):
        if rec.color < 0 or len(rec) == 0:
            continue
        bad = colors[rec.src] != rec.color
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise VerificationError(
                "schedule/color-discipline",
                f"slot {t} has color {rec.color} but sender "
                f"{int(rec.src[i])} has color {int(colors[rec.src[i]])}",
                {"slot": t, "node": int(rec.src[i])})


def check_proper_coloring(facts: PlanFacts) -> None:
    colors = facts.colors
    for t, rec in enumerate(facts.slots):
        if rec.color < 0 or len(rec) == 0:
            continue
        cs, cd = colors[rec.src], colors[rec.dst]
        bad = (cs == cd) & (cs >= 0)
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise VerificationError(
                "schedule/proper-coloring",
                f"used edge {int(rec.src[i])} -- {int(rec.dst[i])} has equal "
                f"endpoint colors ({int(cs[i])}) in slot {t}",
                {"slot": t, "edge": (int(rec.src[i]), int(rec.dst[i]))})


def check_degree_cap(facts: PlanFacts) -> None:
    n = np.int64(facts.n)
    P = np.int64(max(facts.n_payloads, 1))
    deg = None
    if facts.graph is not None:
        _, _, deg = _csr(facts.graph)
    for t, rec in enumerate(facts.slots):
        if len(rec) == 0:
            continue
        if rec.color < 0:
            # uncolored (slot-synchronous) slots may reuse a link for
            # different payloads (flooding); only an exact duplicate send
            # is a defect
            key = (rec.src * n + rec.dst) * P + rec.payload
            uniq, counts = np.unique(key, return_counts=True)
            if (counts > 1).any():
                k = int(uniq[np.flatnonzero(counts > 1)[0]]) // P
                raise VerificationError(
                    "schedule/degree-cap",
                    f"slot {t}: identical send {k // facts.n} -> "
                    f"{k % facts.n} scheduled twice", {"slot": t})
            continue
        key = rec.src * n + rec.dst
        uniq, counts = np.unique(key, return_counts=True)
        if (counts > 1).any():
            k = int(uniq[np.flatnonzero(counts > 1)[0]])
            raise VerificationError(
                "schedule/degree-cap",
                f"slot {t}: directed link {k // facts.n} -> {k % facts.n} "
                f"used more than once", {"slot": t})
        if deg is not None:
            per_node = np.bincount(rec.src, minlength=facts.n)
            over = per_node > deg
            if over.any():
                u = int(np.flatnonzero(over)[0])
                raise VerificationError(
                    "schedule/degree-cap",
                    f"slot {t}: node {u} emits {int(per_node[u])} sends but "
                    f"has degree {int(deg[u])}", {"slot": t, "node": u})


# ---------------------------------------------------------------------------
# capacity admissibility
# ---------------------------------------------------------------------------


def check_capacity(facts: PlanFacts, network) -> int:
    """Admissibility on a :class:`~repro_torch.core.network.CompiledNetwork`:
    every send's route resolves, every traversed access/trunk link has
    positive capacity, and the per-flow cap is positive — the assumptions
    the fluid/analytic/event timing models divide by. Returns the peak
    per-link flow count across slots (recorded in the certificate)."""
    if network.per_flow_cap_mbps <= 0:
        raise VerificationError(
            "capacity/admissible",
            f"per_flow_cap_mbps={network.per_flow_cap_mbps} is not positive")
    rates = np.asarray(network.access_rate, dtype=np.float64)
    sub = network.node_subnet
    trunk_mbps = float(network.spec.trunk_mbps)
    n_trunks = len(network.trunk_edges)
    peak = 0
    for t, rec in enumerate(facts.slots):
        if len(rec) == 0:
            continue
        for name, nodes in (("access-up", rec.src), ("access-down", rec.dst)):
            bad = rates[nodes] <= 0
            if bad.any():
                u = int(nodes[np.flatnonzero(bad)[0]])
                raise VerificationError(
                    "capacity/admissible",
                    f"slot {t}: {name} link of node {u} has capacity "
                    f"{rates[u]} Mbps", {"slot": t, "node": u})
        up = np.bincount(rec.src, minlength=facts.n)
        down = np.bincount(rec.dst, minlength=facts.n)
        peak = max(peak, int(up.max()), int(down.max()))
        s, d = sub[rec.src], sub[rec.dst]
        cross = s != d
        if cross.any():
            if trunk_mbps <= 0:
                raise VerificationError(
                    "capacity/admissible",
                    f"slot {t}: cross-subnet sends but trunk capacity is "
                    f"{trunk_mbps} Mbps", {"slot": t})
            trunks = network.route_trunks[s[cross], d[cross]].ravel()
            trunks = trunks[trunks >= 0]
            # routes exist for every pair by CompiledNetwork construction;
            # a cross-subnet send whose route lists no trunk would mean the
            # route table is inconsistent with the subnet map
            per_pair = network.route_trunks[s[cross], d[cross]]
            unrouted = (per_pair < 0).all(axis=1)
            if unrouted.any():
                i = int(np.flatnonzero(cross)[0])
                raise VerificationError(
                    "capacity/admissible",
                    f"slot {t}: no trunk route between subnets "
                    f"{int(s[cross][0])} and {int(d[cross][0])} for send "
                    f"#{i}", {"slot": t})
            if trunks.size:
                flows = np.bincount(trunks, minlength=max(n_trunks, 1))
                peak = max(peak, int(flows.max()))
    return peak


# ---------------------------------------------------------------------------
# progress: possession lattices and completeness certificates
# ---------------------------------------------------------------------------


def _check_exchange(facts: PlanFacts) -> Tuple[Optional[int], None]:
    """mosgu_exchange / broadcast_exchange: each node multicasts only its
    *own* payload (causal possession is ``payload == src``) and the send
    set covers the expected directed pairs exactly once (completeness)."""
    n = np.int64(facts.n)
    keys = []
    for t, rec in enumerate(facts.slots):
        if len(rec) == 0:
            continue
        bad = rec.payload != rec.src
        if bad.any():
            i = int(np.flatnonzero(bad)[0])
            raise VerificationError(
                "progress/causal-possession",
                f"slot {t} send #{i}: node {int(rec.src[i])} forwards "
                f"payload {int(rec.payload[i])} it does not own in an "
                f"exchange round", {"slot": t, "index": i})
        keys.append(rec.src * n + rec.dst)
    sent = np.sort(np.concatenate(keys)) if keys else np.zeros(0, np.int64)
    if facts.kind == "broadcast_exchange":
        u = np.repeat(np.arange(facts.n, dtype=np.int64), facts.n - 1)
        v = np.concatenate([np.delete(np.arange(facts.n, dtype=np.int64), i)
                            for i in range(facts.n)]) if facts.n else u
        expect = np.sort(u * n + v)
    elif facts.graph is not None:
        expect = _edge_keys(facts.graph, facts.n)
    else:
        raise _Skip("exchange completeness needs the scheduled graph")
    if sent.shape != expect.shape or not np.array_equal(sent, expect):
        raise VerificationError(
            "progress/completeness",
            f"{facts.kind} sends do not cover every directed neighbour pair "
            f"exactly once ({sent.size} sends vs {expect.size} expected)",
            {"sent": int(sent.size), "expected": int(expect.size)})
    last = max((t for t, rec in enumerate(facts.slots) if len(rec)),
               default=None)
    return last, None


def _check_tree_allreduce(facts: PlanFacts) -> Tuple[Optional[int], None]:
    """Reduce-then-broadcast phase proof: every non-root sends exactly one
    partial sum (tag 0) to its parent after all its children did, then
    receives exactly one mean (tag 1) from its parent before forwarding."""
    parent, root = facts.tree_parent, facts.tree_root
    if parent is None or root is None:
        raise _Skip("tree structure (parent/root) unavailable")
    n = facts.n
    n_children = np.zeros(n, dtype=np.int64)
    for u, p in parent.items():
        if p >= 0:
            n_children[p] += 1
    pending = n_children.copy()  # children whose partial sum is still due
    sent_up = np.zeros(n, dtype=bool)
    has_mean = np.zeros(n, dtype=bool)
    has_mean[root] = True
    completion = None
    for t, rec in enumerate(facts.slots):
        for i in range(len(rec)):
            u, v, tag = int(rec.src[i]), int(rec.dst[i]), int(rec.payload[i])
            if tag == 0:
                if u == root or parent.get(u) != v:
                    raise VerificationError(
                        "progress/causal-possession",
                        f"slot {t}: partial sum {u} -> {v} is not a "
                        f"child-to-parent tree edge", {"slot": t})
                if pending[u] or sent_up[u]:
                    why = ("before its children reduced" if pending[u]
                           else "twice")
                    raise VerificationError(
                        "progress/causal-possession",
                        f"slot {t}: node {u} sends its partial sum {why}",
                        {"slot": t, "node": u})
                sent_up[u] = True
                pending[v] -= 1
            elif tag == 1:
                if parent.get(v) != u:
                    raise VerificationError(
                        "progress/causal-possession",
                        f"slot {t}: mean {u} -> {v} is not a parent-to-child "
                        f"tree edge", {"slot": t})
                if not has_mean[u]:
                    raise VerificationError(
                        "progress/causal-possession",
                        f"slot {t}: node {u} broadcasts the mean before "
                        f"holding it", {"slot": t, "node": u})
                has_mean[v] = True
            else:
                raise VerificationError(
                    "structure/node-range",
                    f"slot {t}: unknown tree-allreduce tag {tag}", {"slot": t})
        if len(rec) and has_mean.all() and completion is None:
            completion = t
    if not (sent_up | (np.arange(n) == root)).all():
        missing = int(np.flatnonzero(~sent_up & (np.arange(n) != root))[0])
        raise VerificationError(
            "progress/completeness",
            f"node {missing} never sent its partial sum to its parent",
            {"node": missing})
    if not has_mean.all():
        missing = int(np.flatnonzero(~has_mean)[0])
        raise VerificationError(
            "progress/completeness",
            f"node {missing} never received the aggregated mean",
            {"node": missing})
    return completion, None


def _check_dense_lattice(
    facts: PlanFacts,
) -> Tuple[Optional[int], Optional[Dict[int, int]]]:
    """Dissemination / segmented / flooding: abstract-interpret the slots
    over a dense (node, payload) possession matrix. Proves both causal
    possession (a forwarder already holds what it forwards) and
    completeness (everyone holds everything by the final slot), plus the
    per-segment completion certificate for segmented gossip."""
    n, P, S = facts.n, facts.n_payloads, facts.segments
    if n * P > MAX_LATTICE_CELLS:
        raise _Skip(f"possession lattice too large ({n} x {P} cells)")
    possessed = np.zeros((n, P), dtype=bool)
    own = np.arange(n, dtype=np.int64)[:, None] * S + np.arange(S)[None, :]
    possessed[np.arange(n)[:, None], own] = True
    missing_per_seg = np.full(S, n * (n - 1), dtype=np.int64)
    seg_completion: Dict[int, int] = {}
    completion = None
    for t, rec in enumerate(facts.slots):
        if len(rec) == 0:
            continue
        held = possessed[rec.src, rec.payload]
        if not held.all():
            i = int(np.flatnonzero(~held)[0])
            raise VerificationError(
                "progress/causal-possession",
                f"slot {t} send #{i}: node {int(rec.src[i])} forwards "
                f"payload {int(rec.payload[i])} before possessing it",
                {"slot": t, "index": i})
        key = rec.dst * np.int64(P) + rec.payload
        fresh = np.unique(key[~possessed[rec.dst, rec.payload]])
        if fresh.size:
            d, p = fresh // P, fresh % P
            possessed[d, p] = True
            np.subtract.at(missing_per_seg, p % S, 1)
            for seg in np.unique(p % S):
                if missing_per_seg[seg] == 0 and int(seg) not in seg_completion:
                    seg_completion[int(seg)] = t
            if completion is None and not missing_per_seg.any():
                completion = t
    if missing_per_seg.any():
        seg = int(np.flatnonzero(missing_per_seg)[0])
        hole = np.flatnonzero(~possessed[:, seg::S].all(axis=1))
        what = (f"segment {seg}" if S > 1 else "some payload")
        raise VerificationError(
            "progress/completeness",
            f"node {int(hole[0])} never received {what} "
            f"({int(missing_per_seg[seg])} (node, payload) cells unreached "
            f"after {facts.n_slots} slots)",
            {"node": int(hole[0]), "segment": seg})
    return completion, (seg_completion if S > 1 else None)


class _Skip(Exception):
    """Internal: a checker cannot run here; the reason lands in
    ``Certificate.skipped`` instead of failing the verification."""


def check_progress(
    facts: PlanFacts,
) -> Tuple[Optional[int], Optional[Dict[int, int]]]:
    """Dispatch to the protocol family's possession/completeness proof.
    Returns ``(completion_slot, per_segment_completion)``."""
    if facts.kind in ("mosgu_exchange", "broadcast_exchange"):
        return _check_exchange(facts)
    if facts.kind == "tree_allreduce":
        return _check_tree_allreduce(facts)
    return _check_dense_lattice(facts)


# ---------------------------------------------------------------------------
# bounded-staleness admission graph
# ---------------------------------------------------------------------------


def admission_edges(n_rounds: int,
                    max_staleness: int) -> List[Tuple[int, int]]:
    """The event engine's admission dependencies as ``(round, waits_on)``
    edges: round ``r`` is admitted when round ``r - 1 - max_staleness``
    completes (rounds ``0..max_staleness`` are admitted unconditionally)."""
    return [(r, r - 1 - max_staleness) for r in range(n_rounds)
            if r - 1 - max_staleness >= 0]


def check_admission_acyclic(n_rounds: int,
                            edges: Sequence[Tuple[int, int]]) -> None:
    """Kahn's topological sort over an explicit admission graph — the
    generic cycle detector :func:`check_admission_schedule` feeds."""
    indeg = np.zeros(n_rounds, dtype=np.int64)
    out: Dict[int, List[int]] = {}
    for r, dep in edges:
        indeg[r] += 1
        out.setdefault(dep, []).append(r)
    ready = [int(r) for r in np.flatnonzero(indeg == 0)]
    seen = 0
    while ready:
        dep = ready.pop()
        seen += 1
        for r in out.get(dep, ()):
            indeg[r] -= 1
            if indeg[r] == 0:
                ready.append(r)
    if seen != n_rounds:
        stuck = sorted(int(r) for r in np.flatnonzero(indeg > 0))
        raise VerificationError(
            "staleness/admission-acyclic",
            f"admission graph has a cycle: rounds {stuck} can never be "
            f"admitted", {"stuck": stuck})


def check_admission_schedule(n_rounds: int, max_staleness: int) -> None:
    """Prove the bounded-staleness window can never deadlock: reject a
    negative window, then show the admission graph is a DAG."""
    if max_staleness < 0:
        raise VerificationError(
            "staleness/window-negative",
            f"max_staleness={max_staleness} must be >= 0")
    check_admission_acyclic(n_rounds, admission_edges(n_rounds, max_staleness))


# ---------------------------------------------------------------------------
# byte conservation
# ---------------------------------------------------------------------------


def _isclose(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-15)


def recompute_wire_mb(facts: PlanFacts, payload_mb: float,
                      codec=None) -> float:
    """Bytes on wire, statically, from plan + codec wire model (MB)."""
    from ..compress import per_send_wire_mb  # numpy-only, no cycle

    return facts.transmissions * per_send_wire_mb(
        codec, payload_mb, facts.payload_fraction)


def check_conservation(facts: PlanFacts, payload_mb: float, codec=None,
                       plan: Optional[SlotPlan] = None,
                       expected_stats: Optional[Dict[str, float]] = None
                       ) -> float:
    """Recompute ``bytes_on_wire`` from the frozen plan and require exact
    agreement with :meth:`SlotPlan.bytes_on_wire` (when a compiled plan is
    at hand) and with an independent counting walk (``expected_stats``,
    e.g. the plan cache's ``measure`` stage). Returns the recomputed MB."""
    from ..compress import per_send_wire_bytes

    wire_mb = recompute_wire_mb(facts, payload_mb, codec)
    per_send = per_send_wire_bytes(
        codec, payload_mb * 1e6 * facts.payload_fraction)
    alt_mb = (facts.transmissions * per_send) / 1e6
    if not _isclose(wire_mb, alt_mb):
        raise VerificationError(
            "conservation/bytes-on-wire",
            f"wire-byte recomputations disagree: {wire_mb!r} MB vs "
            f"{alt_mb!r} MB for {facts.transmissions} sends")
    if plan is not None:
        plan_mb = plan.bytes_on_wire(payload_mb * 1e6, codec) / 1e6
        if not _isclose(plan_mb, wire_mb):
            raise VerificationError(
                "conservation/bytes-on-wire",
                f"SlotPlan.bytes_on_wire gives {plan_mb!r} MB but the "
                f"static recomputation gives {wire_mb!r} MB")
    if expected_stats is not None:
        for key, mine in (("n_slots", facts.n_slots),
                          ("transmissions", facts.transmissions)):
            theirs = expected_stats.get(key)
            if theirs is not None and int(theirs) != int(mine):
                raise VerificationError(
                    "conservation/bytes-on-wire",
                    f"verification walk counted {key}={mine} but the "
                    f"counting executor reports {int(theirs)}")
    return wire_mb


def check_report_conservation(facts: PlanFacts, payload_mb: float, codec,
                              report) -> None:
    """One executor round report's byte fields, rechecked against the
    static wire model. Accepts both exact accumulation orders the
    executors use (``tx * wire`` and ``sum([wire] * tx)``)."""
    tx = int(report.transmissions)
    drops = int(getattr(report, "drops", 0) or 0)
    from ..compress import per_send_wire_mb

    wire = per_send_wire_mb(codec, payload_mb, facts.payload_fraction)
    expect_a = tx * wire
    expect_b = float(sum([wire] * tx)) if tx <= 1_000_000 else expect_a
    got = float(report.bytes_on_wire_mb)
    if not (_isclose(got, expect_a) or _isclose(got, expect_b)):
        raise VerificationError(
            "conservation/bytes-on-wire",
            f"round {report.round}: reported bytes_on_wire_mb={got!r} but "
            f"{tx} transmissions x {wire!r} MB = {expect_a!r}",
            {"round": int(report.round)})
    expect_raw = tx * payload_mb * facts.payload_fraction
    if not _isclose(float(report.bytes_mb), expect_raw):
        raise VerificationError(
            "conservation/bytes-on-wire",
            f"round {report.round}: reported bytes_mb="
            f"{float(report.bytes_mb)!r} but {tx} transmissions x "
            f"{payload_mb!r} x {facts.payload_fraction!r} = {expect_raw!r}",
            {"round": int(report.round)})
    if drops == 0 and facts.kind not in ("flooding",):
        # failure-free rounds replay the plan exactly; the transmission
        # count must match the frozen plan's
        if tx != facts.transmissions and tx != 0:
            raise VerificationError(
                "conservation/bytes-on-wire",
                f"round {report.round}: {tx} transmissions reported but the "
                f"plan schedules {facts.transmissions}",
                {"round": int(report.round)})
