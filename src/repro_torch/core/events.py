"""Discrete-event asynchronous protocol engine (the ``event`` executor's core).

The port's copy of ``repro_torch.core.events``: numpy and ``heapq``, with the
reference's heap tie-breaking, seeded draw order and float operand order,
so every timing equals the reference's.

Every other executor is round-synchronous: a global barrier ends round r
everywhere before round r+1 starts anywhere. Real deployments are not — a
node transmits whenever its own schedule slot and its links allow, and a
straggler delays only the nodes that depend on its data. This module
simulates exactly that, over the same communication-plan IR
(:class:`~repro_torch.core.plan.CommPolicy` slot structure) the other executors
interpret:

* **per-node virtual clocks** — node ``u`` holds a *milestone* per slot
  boundary: milestone ``t`` fires once u has (a) reached milestone ``t-1``,
  (b) finished injecting its own slot-``t-1`` sends into its access-up
  link, and (c) received every slot-``t-1`` delivery addressed to it.
  Nothing else gates it, so a node whose dependencies cleared early runs
  slots (and, for segmented protocols, per-segment sends) ahead of
  stragglers elsewhere in the same round — the pipelining of the segmented
  gossip paper, at link granularity.
* **link-busy intervals** — each transfer walks its physical route
  (access-up, trunks, access-down, from
  :meth:`~repro_torch.core.network.CompiledNetwork.links_for`) store-and-forward:
  service on a link starts at ``max(arrival, link_free)`` and takes
  ``size / min(capacity, per_flow_cap)``; ``link_free`` advances to the
  finish. Links are keyed by *physical* identity (device id / router
  pair), so contention persists across churn epochs and across
  concurrently-running rounds.
* **bounded staleness** — round ``r`` is *admitted* when round
  ``r - 1 - max_staleness`` completes (``max_staleness=0`` reproduces the
  global barrier: at most one round in flight). A node starts its round-r
  work at ``max(admission, its own round-(r-1) finish)`` plus its seeded
  compute time — the straggler model.
* **virtual-time churn and drops** — membership changes take effect at the
  round's admission timestamp (recorded per event), and transfer failures
  are drawn per attempt at the transfer's virtual launch, burn their wire
  time, and retransmit from the failed delivery's timestamp.

The engine is deterministic by construction: the event heap breaks time
ties by insertion sequence, and the only randomness (drops, compute
jitter) comes from seeded generators whose draw order is the heap order.
Two runs with identical inputs produce identical event logs, timings and
byte counts.

:func:`repro_torch.core.network.estimate_throughput` runs this engine for a
single round to derive its pipeline-fill latency and per-link busy
integrals — the analytic steady-state form is calibrated against (and
tested within ±15% of) multi-round engine runs.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["AsyncEventEngine", "RoundTiming", "policy_slots", "plan_slots"]


def policy_slots(policy) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Freeze a :class:`~repro_torch.core.plan.CommPolicy` into per-slot
    ``(src, dst)`` send arrays (dense member indices) with one walk."""
    policy.reset()
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    t = 0
    while not policy.done():
        sends = policy.emit(t)
        policy.commit(t, sends)
        out.append((np.asarray(sends.src, dtype=np.int64).copy(),
                    np.asarray(sends.dst, dtype=np.int64).copy()))
        t += 1
    return out


def plan_slots(plan) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-slot (src, dst) arrays from a live policy *or* a compiled
    :class:`~repro_torch.core.plan.SlotPlan` (same duck-typing rule as
    :func:`repro_torch.core.network.estimate_timing`)."""
    if hasattr(plan, "emit"):
        return policy_slots(plan)
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    for slot in plan.slots:
        arr = np.asarray(slot.sends, dtype=np.int64).reshape(-1, 3)
        out.append((arr[:, 0].copy(), arr[:, 1].copy()))
    return out


@dataclass(frozen=True)
class RoundTiming:
    """Virtual-clock outcome of one round on the event engine."""

    round_idx: int
    admitted_s: float  # when the staleness window let the round in
    started_s: float  # earliest node start (compute included)
    completed_s: float  # last milestone (== last delivery or later)
    attempts: int  # transfers launched, retransmissions included
    drops: int  # failed attempts (each burned its wire time)
    sum_transfer_s: float  # Σ (delivery - launch) over successful transfers
    sum_rate_mbps: float  # Σ (size / duration) over successful transfers
    max_in_flight: int  # peak concurrent transfers while this round ran

    @property
    def makespan_s(self) -> float:
        return self.completed_s - self.admitted_s

    def mean_transfer_s(self) -> Optional[float]:
        ok = self.attempts - self.drops
        return self.sum_transfer_s / ok if ok else None

    def mean_bandwidth_mbps(self) -> Optional[float]:
        ok = self.attempts - self.drops
        return self.sum_rate_mbps / ok if ok else None


class _Round:
    """Frozen inputs + live gating state of one registered round."""

    __slots__ = (
        "idx", "members", "net", "slots", "n_slots", "size_mb", "compute_s",
        "need", "got", "gate_time", "m_slot", "m_time", "waiting", "started",
        "finished", "out_by_slot", "done_count", "admitted", "admit_t",
        "prev_round", "attempts", "drops", "sum_transfer", "sum_rate",
        "inflight", "max_inflight", "start_min", "completed_t", "rng",
        "path_cache", "start_t", "done_t",
    )

    def __init__(self, idx: int, members: Tuple[int, ...], net,
                 slots: Sequence[Tuple[np.ndarray, np.ndarray]],
                 size_mb: float, compute_s: np.ndarray) -> None:
        self.idx = idx
        self.members = members
        self.net = net
        self.slots = list(slots)
        self.n_slots = len(self.slots)
        self.size_mb = float(size_mb)
        self.compute_s = compute_s
        n = len(members)
        T = max(self.n_slots, 1)
        # gate bookkeeping per (node, slot): how many arrivals (deliveries
        # to the node + its own injection completion) milestone t+1 waits on
        self.need = np.zeros((n, T), dtype=np.int64)
        self.got = np.zeros((n, T), dtype=np.int64)
        self.gate_time = np.zeros((n, T), dtype=np.float64)
        self.out_by_slot: List[Dict[int, np.ndarray]] = []
        for t, (src, dst) in enumerate(self.slots):
            if src.size:
                np.add.at(self.need[:, t], dst, 1)
                order = np.argsort(src, kind="stable")  # keeps plan order
                ssorted, dsorted = src[order], dst[order]
                senders = np.unique(ssorted)
                lo = np.searchsorted(ssorted, senders, side="left")
                hi = np.searchsorted(ssorted, senders, side="right")
                self.out_by_slot.append(
                    {int(u): dsorted[a:b]
                     for u, a, b in zip(senders, lo, hi)})
                self.need[senders, t] += 1  # own-injection gate unit
            else:
                self.out_by_slot.append({})
        self.m_slot = np.zeros(n, dtype=np.int64)
        self.m_time = np.zeros(n, dtype=np.float64)
        self.waiting = np.zeros(n, dtype=bool)
        self.started = np.zeros(n, dtype=bool)
        self.finished = np.zeros(n, dtype=bool)
        self.done_count = 0
        self.admitted = False
        self.admit_t = 0.0
        self.prev_round: Optional[np.ndarray] = None  # filled by the engine
        self.attempts = 0
        self.drops = 0
        self.sum_transfer = 0.0
        self.sum_rate = 0.0
        self.inflight = 0
        self.max_inflight = 0
        self.start_min = np.inf
        self.completed_t = 0.0
        self.start_t = np.zeros(n, dtype=np.float64)  # milestone-0 time
        self.done_t = np.zeros(n, dtype=np.float64)  # last-milestone time
        self.rng: Optional[np.random.Generator] = None
        self.path_cache: Dict[Tuple[int, int], tuple] = {}


class AsyncEventEngine:
    """The discrete-event simulator: register rounds, then :meth:`run`.

    ``max_staleness`` bounds how many rounds may overlap (0 = barrier);
    ``drop_rate``/``drop_seed`` draw per-attempt transfer failures with the
    same ``[seed, round]`` stream family as the queue engine;
    ``record_events`` keeps the full event log (``self.events``) for
    determinism checks and trace inspection.
    """

    def __init__(self, max_staleness: int = 0, drop_rate: float = 0.0,
                 drop_seed: int = 0, record_events: bool = False) -> None:
        self.max_staleness = int(max_staleness)
        self.drop_rate = float(drop_rate)
        self.drop_seed = int(drop_seed)
        self.record_events = bool(record_events)
        self.events: List[Tuple[Any, ...]] = []
        # per-attempt physical transfers, kept only under record_events:
        # (round, src_i, dst_i, slot, launch_t, ((link_key, start, end), ...),
        #  dropped) — the raw material of virtual_spans()
        self.transfers: List[Tuple[Any, ...]] = []
        self.link_free: Dict[Tuple[Any, ...], float] = {}
        self.link_busy: Dict[Tuple[Any, ...], float] = {}
        self._rounds: List[_Round] = []
        self._node_done_t: Dict[int, float] = {}  # physical id -> finish time

    # -- registration --------------------------------------------------------
    def add_round(self, members: Sequence[int], network,
                  slots: Sequence[Tuple[np.ndarray, np.ndarray]],
                  size_mb: float,
                  compute_s: Optional[np.ndarray] = None) -> None:
        """Register the next round: ``members`` are physical node ids,
        ``network`` the member-masked compiled underlay, ``slots`` the
        epoch's per-slot (src, dst) dense send arrays, ``compute_s`` the
        per-node local compute offsets (zeros when omitted)."""
        members = tuple(int(u) for u in members)
        if compute_s is None:
            compute_s = np.zeros(len(members))
        self._rounds.append(_Round(len(self._rounds), members, network,
                                   slots, size_mb,
                                   np.asarray(compute_s, dtype=np.float64)))

    # -- simulation ----------------------------------------------------------
    def run(self) -> List[RoundTiming]:
        """Simulate every registered round; returns per-round timings."""
        rounds = self._rounds
        # per round, per dense node: the previous round (index) this
        # physical node participated in, or -1 (its start gate)
        last_seen: Dict[int, int] = {}
        for rs in rounds:
            prev = np.full(len(rs.members), -1, dtype=np.int64)
            for i, u in enumerate(rs.members):
                prev[i] = last_seen.get(u, -1)
            rs.prev_round = prev
            for u in rs.members:
                last_seen[u] = rs.idx
            if self.drop_rate > 0:
                rs.rng = np.random.default_rng([self.drop_seed, rs.idx])
        heap: List[Tuple[float, int, int, int, int, int]] = []
        self._heap = heap
        self._seq = 0
        # kinds: 0 admit, 1 milestone(u, t), 2 deliver(v, t), 3 retry(u, v|t)
        for r in range(min(self.max_staleness + 1, len(rounds))):
            self._push(0.0, 0, r, 0, 0)
        timings: List[Optional[RoundTiming]] = [None] * len(rounds)
        while heap:
            T, _seq, kind, r, a, b = heapq.heappop(heap)
            rs = rounds[r]
            if self.record_events:
                self.events.append(
                    (T, ("admit", "milestone", "deliver", "retry")[kind],
                     r, a, b))
            if kind == 0:
                self._admit(rs, T)
            elif kind == 1:
                self._milestone(rs, a, b, T, timings)
            elif kind == 2:
                self._deliver(rs, a, b, T)
            else:  # retransmission: the failed attempt ended, relaunch now
                v, t = divmod(b, rs.n_slots + 1)
                rs.inflight -= 1
                self._launch(rs, a, v, t, T)
        if any(t is None for t in timings):
            stuck = [i for i, t in enumerate(timings) if t is None]
            raise RuntimeError(
                f"event engine deadlocked: rounds {stuck} never completed")
        return timings  # type: ignore[return-value]

    # -- event handlers ------------------------------------------------------
    def _push(self, time: float, kind: int, r: int, a: int, b: int) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (time, self._seq, kind, r, a, b))

    def _admit(self, rs: _Round, T: float) -> None:
        rs.admitted = True
        rs.admit_t = T
        for i in range(len(rs.members)):
            self._maybe_start(rs, i, T)

    def _maybe_start(self, rs: _Round, i: int, now: float) -> None:
        if rs.started[i] or not rs.admitted:
            return
        pr = int(rs.prev_round[i])
        if pr >= 0 and not self._rounds[pr].finished[
                self._rounds[pr].members.index(rs.members[i])]:
            return
        t0 = max(rs.admit_t, self._node_done_t.get(rs.members[i], 0.0),
                 now) + float(rs.compute_s[i])
        rs.started[i] = True
        rs.start_t[i] = t0
        rs.start_min = min(rs.start_min, t0)
        self._push(t0, 1, rs.idx, i, 0)

    def _milestone(self, rs: _Round, i: int, t: int, T: float,
                   timings: List[Optional[RoundTiming]]) -> None:
        rs.m_slot[i] = t
        rs.m_time[i] = T
        if t == rs.n_slots:
            self._finish_node(rs, i, T, timings)
            return
        dsts = rs.out_by_slot[t].get(i)
        if dsts is not None:
            inj = T
            for v in dsts:
                up_done, _delivered = self._launch(rs, i, int(v), t, T)
                inj = max(inj, up_done)
            rs.got[i, t] += 1  # own-injection gate unit
            rs.gate_time[i, t] = max(rs.gate_time[i, t], inj)
        rs.waiting[i] = True
        self._try_advance(rs, i)

    def _try_advance(self, rs: _Round, i: int) -> None:
        t = int(rs.m_slot[i])
        if not rs.waiting[i] or rs.got[i, t] < rs.need[i, t]:
            return
        rs.waiting[i] = False
        nxt = max(float(rs.m_time[i]), float(rs.gate_time[i, t]))
        self._push(nxt, 1, rs.idx, i, t + 1)
        rs.m_slot[i] = t + 1  # scheduled; pop re-asserts

    def _deliver(self, rs: _Round, i: int, t: int, T: float) -> None:
        rs.inflight -= 1
        rs.got[i, t] += 1
        rs.gate_time[i, t] = max(rs.gate_time[i, t], T)
        if rs.m_slot[i] == t:
            self._try_advance(rs, i)

    def _finish_node(self, rs: _Round, i: int, T: float,
                     timings: List[Optional[RoundTiming]]) -> None:
        if rs.finished[i]:
            return
        rs.finished[i] = True
        rs.done_t[i] = T
        u = rs.members[i]
        self._node_done_t[u] = max(self._node_done_t.get(u, 0.0), T)
        rs.done_count += 1
        # the node may now start its next registered round (if admitted)
        nxt = self._next_round_of(u, rs.idx)
        if nxt is not None:
            nrs = self._rounds[nxt]
            self._maybe_start(nrs, nrs.members.index(u), T)
        if rs.done_count == len(rs.members):
            rs.completed_t = T
            timings[rs.idx] = RoundTiming(
                round_idx=rs.idx, admitted_s=rs.admit_t,
                started_s=float(rs.start_min), completed_s=T,
                attempts=rs.attempts, drops=rs.drops,
                sum_transfer_s=rs.sum_transfer, sum_rate_mbps=rs.sum_rate,
                max_in_flight=rs.max_inflight)
            nxt_admit = rs.idx + self.max_staleness + 1
            if nxt_admit < len(self._rounds):
                self._push(T, 0, nxt_admit, 0, 0)

    def node_spans(self, round_idx: int = 0) -> np.ndarray:
        """Per-node serial span of one completed round: local compute plus
        the node's milestone-0 -> last-milestone work. In steady state with
        ``max_staleness >= 1`` a node's successive rounds chain on exactly
        this quantity, so its maximum lower-bounds the inter-round period
        (used by :func:`repro_torch.core.network.estimate_throughput`)."""
        rs = self._rounds[round_idx]
        return rs.compute_s + (rs.done_t - rs.start_t)

    def virtual_spans(self) -> List[Dict[str, Any]]:
        """Map the run onto virtual-time spans for the observability layer
        (requires ``record_events=True`` for the per-link lanes).

        Returned dicts carry ``name/track/cat/t0/t1/args`` in engine virtual
        seconds, one lane per physical node (``node/<id>``: a compute span
        ending at milestone 0, then the slot-walk work span) and one lane
        per physical link (``link/up:<id>``, ``link/down:<id>``,
        ``link/trunk:<a>-<b>``: the store-and-forward busy interval of every
        transfer attempt, drops included). The event executor feeds these
        straight into :meth:`repro_torch.obs.Recorder.add_span`."""
        spans: List[Dict[str, Any]] = []
        for rs in self._rounds:
            for i, u in enumerate(rs.members):
                if not rs.finished[i]:
                    continue
                c = float(rs.compute_s[i])
                s0 = float(rs.start_t[i])
                if c > 0:
                    spans.append({"name": f"compute r{rs.idx}",
                                  "track": f"node/{u}", "cat": "compute",
                                  "t0": s0 - c, "t1": s0,
                                  "args": {"round": rs.idx}})
                spans.append({"name": f"round {rs.idx}",
                              "track": f"node/{u}", "cat": "node",
                              "t0": s0, "t1": float(rs.done_t[i]),
                              "args": {"round": rs.idx}})
        for r, i, v, t, _T, segs, dropped in self.transfers:
            mem = self._rounds[r].members
            name = f"{mem[i]}->{mem[v]} s{t}" + (" drop" if dropped else "")
            for key, start, end in segs:
                if key[0] in ("up", "down"):
                    track = f"link/{key[0]}:{key[1]}"
                else:  # ("trunk", a, b)
                    track = f"link/trunk:{key[1]}-{key[2]}"
                spans.append({"name": name, "track": track, "cat": "link",
                              "t0": start, "t1": end,
                              "args": {"round": r, "slot": t,
                                       "dropped": dropped}})
        return spans

    def _next_round_of(self, u: int, after: int) -> Optional[int]:
        for r in range(after + 1, len(self._rounds)):
            if u in self._rounds[r].members:
                return r
            if not self._rounds[r].admitted:
                # admissions are sequential: everything past here is
                # unadmitted too, and _admit will start u when its turn comes
                break
        return None

    # -- the link walk -------------------------------------------------------
    def _route(self, rs: _Round, u: int, v: int):
        """Physical link keys + capacities of the u -> v route (cached per
        subnet-respecting endpoint pair within the round's epoch)."""
        key = (u, v)
        cached = rs.path_cache.get(key)
        if cached is not None:
            return cached
        net = rs.net
        mem = rs.members
        path = []
        for link in net.links_for(u, v):
            if link[0] == "access-up":
                path.append((("up", mem[link[1]]), net.capacity(link)))
            elif link[0] == "access-down":
                path.append((("down", mem[link[1]]), net.capacity(link)))
            else:  # ("trunk", a, b): router ids are churn-stable
                path.append((link, net.capacity(link)))
        route = (tuple(path), float(net.latency(u, v)))
        rs.path_cache[key] = route
        return route

    def _launch(self, rs: _Round, i: int, v: int, t: int,
                T: float) -> Tuple[float, float]:
        """One transfer attempt i -> v at virtual time ``T``; walks the
        route, draws the drop, schedules delivery or retransmission.
        Returns (access-up completion, delivery-or-failure time)."""
        path, lat = self._route(rs, i, v)
        cap = rs.net.per_flow_cap_mbps
        arr = T + lat
        up_done = arr
        segs: List[Tuple[Any, float, float]] = []
        for li, (key, C) in enumerate(path):
            start = max(arr, self.link_free.get(key, 0.0))
            service = rs.size_mb / min(C, cap)
            arr = start + service
            self.link_free[key] = arr
            self.link_busy[key] = self.link_busy.get(key, 0.0) + service
            if li == 0:
                up_done = arr
            if self.record_events:
                segs.append((key, start, arr))
        rs.attempts += 1
        rs.inflight += 1
        rs.max_inflight = max(rs.max_inflight, rs.inflight)
        dropped = rs.rng is not None and bool(rs.rng.random() < self.drop_rate)
        if self.record_events:
            self.transfers.append((rs.idx, i, v, t, T, tuple(segs), dropped))
        if dropped:
            rs.drops += 1
            # the sender notices at the failed delivery time and relaunches;
            # the failed attempt's wire time stands
            self._push(arr, 3, rs.idx, i, v * (rs.n_slots + 1) + t)
        else:
            rs.sum_transfer += arr - T
            rs.sum_rate += rs.size_mb / (arr - T)
            self._push(arr, 2, rs.idx, v, t)
        return up_done, arr
