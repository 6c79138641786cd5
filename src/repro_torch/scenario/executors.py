"""The port's ``repro.scenario.executors``: the moderator lifecycle that
every executor shares, the capability check, the four executors that run
a scenario's rounds on the host and the one that runs them on the card.

:func:`membership_rounds` drives the paper's moderator lifecycle (III-A):
connectivity reports filed from the overlay, each round's churn applied,
an emergency election when the moderator itself left, the 2-node floor,
and a round-robin rotation after every round. On a sparse
(:class:`~repro_torch.core.sparse.CSRGraph`) overlay a plain membership
tracker with the same rules replaces the moderator's report table.
:meth:`Executor.execute` takes the scenario's effective overlay from a
:class:`~repro_torch.scenario.cache.PlanCache` (the declared graph, or the
annealed working overlay when the spec declares an optimizer), builds each
membership epoch's policy through the cache (the moderator's member
subgraph; on a CSR overlay the sparse planner's member tree, repaired
incrementally across churn) and its per-send wire size
(:func:`~repro_torch.compress.per_send_wire_mb`), then hands each round to
:meth:`Executor.run_round` as a :class:`RoundContext` (round index,
moderator, members, applied churn) and collects its :class:`RoundReport`.
A fresh cache a call is the default; :func:`~repro_torch.scenario.sweep.
run_sweep` threads one cache through every cell. With a recorder active
the result carries a :class:`~repro_torch.obs.RunReport`:

=========  ================================================================
plan       counting: slots, transmissions and bytes, and the round times of
           the analytic network model (:class:`~repro_torch.core.network.
           TimingProfile` over the member-masked underlay, cached a plan and
           underlay; its walk also counts the slots and transmissions),
           counting only on a CSR overlay; batches a sweep's cells in one
           numpy pass (:meth:`PlanExecutor.run_cells`)
           (``counting_only``, ``provides_timing``)
engine     :class:`~repro_torch.core.gossip.GossipEngine`, the runtime FIFO
           queues: seeded transient link failures (:func:`_drop_fn`) kept
           at the FIFO head and retransmitted; with a codec, each node's
           proxy payload is encoded, moved and decoded, on the card unless
           the executor is built with ``device="cpu"``, its error-feedback
           residuals carried across the rounds of an epoch
           (``supports_drops``, ``moves_payloads``)
netsim     the contended fluid underlay
           (:func:`~repro_torch.core.netsim.simulate_policy`), every round
           simulated: the paper's Tables III-V metrics (``provides_timing``)
device     the gossip collectives on the card (:func:`~repro_torch.dfl.
           collectives.gossip_exchange` over each epoch's device plan, the
           reference's ``jax`` executor, which ``get("jax")`` also returns):
           the nodes' (N, P) parameters moved through the Hopper kernels,
           each live node held to the live nodes' FedAvg within the codec's
           bound (``provides_numerics``, ``moves_payloads``)
event      :class:`~repro_torch.core.events.AsyncEventEngine`, asynchronous
           rounds on per-node virtual clocks: bounded staleness, seeded
           straggler compute, drops and churn at virtual timestamps; rounds
           are registered in :meth:`EventExecutor.run_round` and simulated
           and back-filled in :meth:`EventExecutor.finish`
           (``supports_drops``, ``provides_timing``, ``supports_staleness``)
=========  ================================================================

Host numbers take the reference's operand order and seeded draw order, so
every field equals the reference executor's. A spec needing a capability
an executor lacks raises, naming it and the executors that provide it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Type, Union

import numpy as np
import torch

from .. import DeviceLike, obs, resolve_device
from ..compress.codec import Codec, per_send_wire_mb
from ..core.events import AsyncEventEngine
from ..core.gossip import GossipEngine
from ..core.graph import Graph
from ..core.moderator import ConnectivityReport, Moderator
from ..core.netsim import SimResult, TestbedSpec, simulate_policy
from ..core.network import NetworkSpec, TimingProfile, as_network_model
from ..core.plan import CommPolicy
from ..core.sparse import CSRGraph
from ..dfl.collectives import GossipPlan, gossip_collective_bytes, gossip_exchange
from ..dfl.session import plan_for_members
from .cache import PlanCache
from .spec import (CAPABILITY_FLAGS, ChurnEvent, RoundReport, ScenarioResult, ScenarioSpec,
                   applicable_churn, resolve_gossip_mode)


def _file_initial_reports(mod: Moderator, overlay: Graph) -> None:
    for u in range(overlay.n):
        costs = {v: float(overlay.adj[u, v]) for v in overlay.neighbors(u)}
        mod.receive_report(ConnectivityReport(u, f"node{u}", costs))


def _apply_churn(mod: Moderator, overlay: Graph, churn: Sequence[ChurnEvent],
                 round_idx: int) -> List[ChurnEvent]:
    """Apply this round's feasible membership changes to the moderator's
    table (a rejoin files a symmetric report, as a live ping would)."""
    applied = applicable_churn(churn, round_idx, mod.members, n_limit=overlay.n)
    for ev in applied:
        if ev.action == "leave":
            mod.remove_node(ev.node)
        else:
            costs = {v: float(overlay.adj[ev.node, v])
                     for v in mod.members if overlay.adj[ev.node, v] > 0}
            mod.receive_report(ConnectivityReport(ev.node, f"node{ev.node}", costs))
            for v, c in costs.items():
                mod.reports[v].costs_ms[ev.node] = c
    return applied


def _rotate(mod: Moderator) -> Moderator:
    """Round-robin vote, tallied by the current moderator (paper III-A)."""
    members = mod.members
    cur = mod.moderator_id if mod.moderator_id in members else members[0]
    candidate = members[(members.index(cur) + 1) % len(members)]
    return mod.handover(mod.elect_next({u: candidate for u in members}))


class _SparseMembership:
    """The per-round moderator view on a sparse overlay.

    A :class:`Moderator`'s report table is O(n x degree) dicts, which
    dominates at n = 100k and cannot be filed at 1M; sparse plans need only
    the membership trajectory (the MST and coloring come from the sparse
    planner over the CSR overlay). This tracker keeps the dense lifecycle's
    rules over a plain member set: churn feasibility by
    :func:`applicable_churn`, an emergency election to ``members[0]`` when
    the moderator leaves, and a round-robin rotation."""

    def __init__(self, n: int) -> None:
        self._current = set(range(n))
        self.moderator_id = 0

    @property
    def members(self) -> List[int]:
        return sorted(self._current)

    def apply_churn(self, churn: Sequence[ChurnEvent], round_idx: int,
                    n_limit: int) -> List[ChurnEvent]:
        applied = applicable_churn(churn, round_idx, self.members, n_limit=n_limit)
        for ev in applied:
            if ev.action == "leave":
                self._current.discard(ev.node)
            else:
                self._current.add(ev.node)
        return applied

    def elect(self) -> None:
        members = self.members
        if self.moderator_id not in self._current:
            self.moderator_id = members[0]
        else:  # round-robin rotation, as the unanimous vote tallies
            i = members.index(self.moderator_id)
            self.moderator_id = members[(i + 1) % len(members)]


def _sparse_membership_rounds(spec: ScenarioSpec, overlay: CSRGraph):
    mod = _SparseMembership(overlay.n)
    for r in range(spec.rounds):
        applied = mod.apply_churn(spec.churn, r, overlay.n)
        if mod.moderator_id not in mod._current:
            mod.elect()  # emergency: the moderator itself left
        members = mod.members
        if len(members) < 2:
            raise ValueError(f"scenario {spec.name!r} dropped below 2 nodes")
        yield r, mod, members, applied
        mod.elect()


def membership_rounds(spec: ScenarioSpec, overlay: Union[Graph, CSRGraph]
                      ) -> Iterator[Tuple[int, Moderator, List[int], List[ChurnEvent]]]:
    """Yields ``(round_idx, moderator, members, applied_churn)`` after the
    round's churn, the emergency election and the 2-node floor; rotates the
    moderator when control returns. A CSR overlay gets
    :class:`_SparseMembership` (the same rules, no report table)."""
    if isinstance(overlay, CSRGraph):
        yield from _sparse_membership_rounds(spec, overlay)
        return
    mod = Moderator(0, spec.mst_algorithm, spec.coloring_algorithm,
                    protocol=spec.protocol, n_segments=spec.n_segments)
    _file_initial_reports(mod, overlay)
    for r in range(spec.rounds):
        applied = _apply_churn(mod, overlay, spec.churn, r)
        if mod.moderator_id not in mod.reports:
            # the moderator itself left: emergency round-robin election
            mod = mod.handover(mod.elect_next({}))
        members = mod.members
        if len(members) < 2:
            raise ValueError(f"scenario {spec.name!r} dropped below 2 nodes")
        yield r, mod, members, applied
        mod = _rotate(mod)


def _drop_fn(spec: ScenarioSpec, round_idx: int) -> Optional[Callable[[int, int, int], bool]]:
    """The round's transient link failures: one draw a send from the
    ``[drop_seed, round_idx]`` stream, in the engine's send order."""
    if spec.drop_rate <= 0:
        return None
    rng = np.random.default_rng([spec.drop_seed, round_idx])

    def drop(slot_idx: int, src: int, dst: int) -> bool:
        return bool(rng.random() < spec.drop_rate)

    return drop


def _proxy_payloads(spec: ScenarioSpec, members: Sequence[int],
                    device: torch.device) -> List:
    """The reference's deterministic per-node proxies (64 f32 values a part,
    drawn with numpy from ``[drop_seed, node]``), as tensors on ``device``.
    The queue engine really encodes, moves and decodes them, while byte
    accounting stays at the declared payload size. Segmented protocols get
    one part a segment."""
    segmented = spec.protocol in ("segmented", "segmented_gossip")
    n_parts = spec.n_segments if segmented else 1
    out: List = []
    for u in members:
        rng = np.random.default_rng([spec.drop_seed, u])
        parts = [torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)).to(device)
                 for _ in range(n_parts)]
        out.append(parts if segmented else parts[0])
    return out


def required_capabilities(spec: ScenarioSpec) -> List[Tuple[str, str]]:
    """The capability flags a spec demands, each with the reason why:
    ``spec.require``; ``drop_rate > 0`` needs ``supports_drops``; any of
    ``max_staleness`` / ``compute_time_s`` / ``compute_jitter_s`` needs
    ``supports_staleness``."""
    out: List[Tuple[str, str]] = []
    for flag in spec.require:
        if flag not in CAPABILITY_FLAGS:
            raise ValueError(f"spec.require names unknown capability {flag!r}; known: "
                             f"{CAPABILITY_FLAGS}")
        out.append((flag, "spec.require"))
    have = {flag for flag, _ in out}
    if spec.drop_rate > 0 and "supports_drops" not in have:
        out.append(("supports_drops", f"drop_rate={spec.drop_rate}"))
    async_fields = [f"{f}={getattr(spec, f)}"
                    for f in ("max_staleness", "compute_time_s", "compute_jitter_s")
                    if getattr(spec, f) > 0]
    if async_fields and "supports_staleness" not in have:
        out.append(("supports_staleness", ", ".join(async_fields)))
    return out


def _member_testbed(spec: ScenarioSpec, members: Sequence[int]
                    ) -> Union[TestbedSpec, NetworkSpec]:
    """The underlay restricted to the healthy members (dense reindexing,
    the physical subnet layout and each device's seeded rate kept)."""
    return spec.testbed().masked(members)


def _subgraph_required() -> Graph:
    raise RuntimeError(
        "member subgraph missing from the plan cache: the trajectory replay "
        "files every epoch's subgraph when it first builds it")


@dataclass
class RoundContext:
    """One scheduled round, as the lifecycle loop hands it to an executor."""

    round_idx: int
    moderator: int
    members: Tuple[int, ...]
    applied: List[ChurnEvent]
    spec: ScenarioSpec

    def report(self, **fields) -> RoundReport:
        """A :class:`RoundReport` with the lifecycle-owned fields filled in."""
        return RoundReport(
            round=self.round_idx, protocol=self.spec.protocol, members=list(self.members),
            moderator=self.moderator, churn_applied=[ev.to_dict() for ev in self.applied],
            **fields)


class Executor:
    """One host executor: capability flags, the lifecycle in
    :meth:`execute`, and its hooks: :meth:`begin` (once a run),
    :meth:`begin_epoch` (membership changed), :meth:`run_round` and
    :meth:`finish`. :meth:`execute` resets every per-run state, so one
    instance may run scenarios (or sweep cells) one after another."""

    name = "abstract"
    supports_drops = False
    provides_timing = False
    provides_numerics = False
    moves_payloads = False
    counting_only = False
    supports_staleness = False
    CAPABILITY_FLAGS = CAPABILITY_FLAGS

    spec: ScenarioSpec
    overlay: Union[Graph, CSRGraph]
    payload_mb: float
    codec: Optional[Codec]
    cache: PlanCache
    record_trace: bool = False
    policy: CommPolicy
    wire_send_mb: float

    @classmethod
    def capabilities(cls) -> Dict[str, bool]:
        return {flag: bool(getattr(cls, flag)) for flag in cls.CAPABILITY_FLAGS}

    def check_capabilities(self, spec: ScenarioSpec) -> None:
        """Fail when the spec needs a capability this executor lacks, naming
        it, why the spec needs it and the executors that have it."""
        missing = [(flag, why) for flag, why in required_capabilities(spec)
                   if not getattr(self, flag)]
        if not missing:
            return
        providers = sorted(n for n, caps in capability_table().items()
                           if all(caps[flag] for flag, _ in missing))
        reasons = "; ".join(f"{flag!r} ({why})" for flag, why in missing)
        raise ValueError(
            f"executor {self.name!r} lacks capability {reasons} required by "
            f"scenario {spec.name!r}; executors providing "
            f"{'it' if len(missing) == 1 else 'them all'}: {providers}")

    def begin(self) -> None:
        """Once a run, after the spec, payload and codec are resolved."""

    def begin_epoch(self, mod: Moderator, members: Tuple[int, ...]) -> None:
        """The epoch's policy from the plan cache (over the moderator's member
        subgraph; through the sparse planner on a CSR overlay) and its
        per-send wire size."""
        if isinstance(self.overlay, CSRGraph):
            self.policy = self.cache.sparse_policy(self.spec, members, self.overlay)
        else:
            self.policy = self.cache.policy(self.spec, members,
                                            lambda: mod.build_graph()[0])
        self.wire_send_mb = per_send_wire_mb(self.codec, self.payload_mb,
                                             self.policy.payload_fraction)

    def run_round(self, rctx: RoundContext) -> RoundReport:
        raise NotImplementedError

    def finish(self, result: ScenarioResult) -> ScenarioResult:
        return result

    def execute(self, spec: ScenarioSpec, record_trace: bool = False,
                plan_cache: Optional[PlanCache] = None) -> ScenarioResult:
        spec.validate()
        self.check_capabilities(spec)
        self.spec = spec
        self.record_trace = record_trace
        self.cache = plan_cache if plan_cache is not None else PlanCache()
        rec = obs.get()
        mark = obs.capture_mark(rec, self.cache.snapshot()) if rec.enabled else None
        self.overlay = self.cache.overlay(spec)
        self.payload_mb, self.codec = spec.payload_mb(), spec.codec_obj()
        self.begin()
        track = f"exec/{self.name}"
        reports: List[RoundReport] = []
        epoch: Optional[Tuple[int, ...]] = None
        for r, mod, members, applied in membership_rounds(spec, self.overlay):
            if tuple(members) != epoch:
                epoch = tuple(members)
                with rec.span(f"epoch r{r}", cat="plan", track=track, scenario=spec.name,
                              members=len(epoch)):
                    self.begin_epoch(mod, epoch)
            rctx = RoundContext(r, mod.moderator_id, epoch, applied, spec)
            with rec.span(f"round {r}", cat="round", track=track, scenario=spec.name, round=r):
                reports.append(self.run_round(rctx))
        result = self.finish(ScenarioResult(
            scenario=spec.name, executor=self.name, protocol=spec.protocol,
            payload_mb=self.payload_mb, rounds=reports, spec=spec.to_dict()))
        if rec.enabled:
            self._observe(rec, mark, result)
        return result

    def _observe(self, rec, mark: Dict[str, Any], result: ScenarioResult) -> None:
        """Tally the run's byte and traffic counters (after :meth:`finish`,
        so back-filled reports count right) and attach the RunReport delta
        to the result."""
        for rep in result.rounds:
            rec.count("bytes.payload_mb", rep.bytes_mb)
            rec.count("bytes.wire_mb", rep.bytes_on_wire_mb)
            rec.count("transmissions", rep.transmissions)
            rec.count("slots", rep.n_slots)
            if rep.drops:
                rec.count("drops", rep.drops)
        result.report = obs.build_report(rec, mark, self.cache.snapshot()).to_dict()

    def run_cells(self, cells, plan_cache: Optional[PlanCache] = None,
                  record_trace: bool = False) -> List[ScenarioResult]:
        """Run sweep cells one after another on this instance through one
        shared plan cache (the plan executor overrides it with a batched
        pass)."""
        cache = plan_cache if plan_cache is not None else PlanCache()
        return [self.execute(cell.spec, record_trace=record_trace, plan_cache=cache)
                for cell in cells]


# the port's executors by name, in the reference's registration order
EXECUTORS: Dict[str, Type[Executor]] = {}
# the reference's names for the same entries (its "jax" is the card executor)
ALIASES = {"jax": "device"}


def register(name: str) -> Callable[[Type[Executor]], Type[Executor]]:
    """Class decorator: register an :class:`Executor` subclass under ``name``."""

    def deco(cls: Type[Executor]) -> Type[Executor]:
        cls.name = name
        EXECUTORS[name] = cls
        return cls

    return deco


def get(name: Union[str, Executor]) -> Executor:
    """A fresh executor instance for ``name`` (an instance passes through)."""
    if isinstance(name, Executor):
        return name
    try:
        return EXECUTORS[ALIASES.get(name, name)]()
    except KeyError:
        raise ValueError(f"unknown executor {name!r}; known: {names()}") from None


def names() -> List[str]:
    return list(EXECUTORS)


def capability_table() -> Dict[str, Dict[str, bool]]:
    """name -> capability flags."""
    return {n: cls.capabilities() for n, cls in EXECUTORS.items()}


@register("plan")
class PlanExecutor(Executor):
    """Counting and the analytic round times: each epoch's
    :class:`TimingProfile` over the member-masked underlay (cached a plan
    and underlay), evaluated at the epoch's per-send wire size; its walk
    gives the slot and transmission counts (``measure_stats``, the seed of
    the measure cache). On a CSR overlay it counts only: the analytic walk
    needs the dense member-masked underlay."""

    counting_only = True
    provides_timing = True

    def begin_epoch(self, mod: Moderator, members: Tuple[int, ...]) -> None:
        super().begin_epoch(mod, members)
        if isinstance(self.overlay, CSRGraph):
            self._stats = self.cache.measure(self.spec, members, self.policy)
            self._timing = None
            return
        testbed = _member_testbed(self.spec, members)
        profile = self.cache.timing(
            self.spec, members, testbed,
            lambda: TimingProfile.from_policy(self.policy, testbed))
        self._stats = self.cache.measure(self.spec, members, self.policy,
                                         stats=profile.measure_stats())
        self._timing = profile.estimate(self.wire_send_mb)

    def run_round(self, rctx: RoundContext) -> RoundReport:
        tx, est = self._stats["transmissions"], self._timing
        timing_fields = {} if est is None else dict(
            total_time_s=est.total_time_s, mean_transfer_s=est.mean_transfer_s,
            mean_bandwidth_mbps=est.mean_bandwidth_mbps,
            max_concurrency=est.max_concurrency)
        return rctx.report(
            n_slots=self._stats["n_slots"], transmissions=tx,
            bytes_mb=tx * self.payload_mb * self.policy.payload_fraction,
            bytes_on_wire_mb=tx * self.wire_send_mb, **timing_fields)

    def run_cells(self, cells, plan_cache: Optional[PlanCache] = None,
                  record_trace: bool = False) -> List[ScenarioResult]:
        """Every cell's counting in one pass: membership trajectories and plan
        stats come from the cache (once a unique key), then every (cell,
        round) row's byte accounting is one vectorized numpy sweep, in
        :meth:`run_round`'s operand order, so the results equal the serial
        path's bit for bit. With a recorder active the cells run one by one
        (each with its own RunReport); a CSR cell always does."""
        rec = obs.get()
        if rec.enabled:
            cells = list(cells)
            with rec.span(f"run_cells x{len(cells)}", cat="sweep", track="exec/plan"):
                return Executor.run_cells(self, cells, plan_cache=plan_cache,
                                          record_trace=record_trace)
        cache = plan_cache if plan_cache is not None else PlanCache()
        wire_memo: Dict[Tuple[str, float, float], float] = {}
        est_memo: Dict[Tuple[int, float], Any] = {}
        rows: List[Tuple] = []  # (cell_idx, rctx, n_slots, tx, frac, wire, est)
        cell_meta: List[Tuple[ScenarioSpec, float]] = []
        sparse_results: Dict[int, ScenarioResult] = {}
        for ci, cell in enumerate(cells):
            spec = cell.spec
            spec.validate()
            self.check_capabilities(spec)
            overlay = cache.overlay(spec)
            if isinstance(overlay, CSRGraph):
                sparse_results[ci] = self.execute(spec, record_trace=record_trace,
                                                  plan_cache=cache)
                cell_meta.append((spec, spec.payload_mb()))
                continue
            payload_mb = spec.payload_mb()
            codec = spec.codec_obj()
            cell_meta.append((spec, payload_mb))

            def build_trajectory(spec=spec, overlay=overlay):
                # files each epoch's member subgraph while the moderator is at
                # hand, so a trajectory hit never needs one
                out = []
                for r, mod, members, applied in membership_rounds(spec, overlay):
                    mt = tuple(members)
                    cache.subgraph(spec, mt, lambda mod=mod: mod.build_graph()[0])
                    out.append((r, mod.moderator_id, mt, applied))
                return out

            for r, moderator, members, applied in cache.trajectory(spec, build_trajectory):
                pol = cache.policy(spec, members, _subgraph_required)
                wire_key = (spec.codec, payload_mb, pol.payload_fraction)
                wire_mb = wire_memo.get(wire_key)
                if wire_mb is None:
                    wire_mb = wire_memo[wire_key] = per_send_wire_mb(
                        codec, payload_mb, pol.payload_fraction)
                testbed = _member_testbed(spec, members)
                profile = cache.timing(spec, members, testbed,
                                       lambda: TimingProfile.from_policy(pol, testbed))
                stats = cache.measure(spec, members, pol, stats=profile.measure_stats())
                est_key = (id(profile), wire_mb)
                est = est_memo.get(est_key)
                if est is None:
                    est = est_memo[est_key] = profile.estimate(wire_mb)
                rows.append((ci, RoundContext(r, moderator, members, applied, spec),
                             stats["n_slots"], stats["transmissions"],
                             pol.payload_fraction, wire_mb, est))
        tx = np.array([row[3] for row in rows], dtype=np.float64)
        payload = np.array([cell_meta[row[0]][1] for row in rows], dtype=np.float64)
        frac = np.array([row[4] for row in rows], dtype=np.float64)
        wire = np.array([row[5] for row in rows], dtype=np.float64)
        bytes_mb = (tx * payload) * frac
        bytes_on_wire = tx * wire
        per_cell: List[List[RoundReport]] = [[] for _ in cells]
        for i, (ci, rctx, n_slots, tx_i, _frac, _wire, est) in enumerate(rows):
            per_cell[ci].append(rctx.report(
                n_slots=n_slots, transmissions=tx_i, bytes_mb=float(bytes_mb[i]),
                bytes_on_wire_mb=float(bytes_on_wire[i]), total_time_s=est.total_time_s,
                mean_transfer_s=est.mean_transfer_s,
                mean_bandwidth_mbps=est.mean_bandwidth_mbps,
                max_concurrency=est.max_concurrency))
        return [sparse_results.get(ci) or ScenarioResult(
            scenario=spec.name, executor=self.name, protocol=spec.protocol,
            payload_mb=payload_mb, rounds=reps, spec=spec.to_dict())
            for ci, ((spec, payload_mb), reps) in enumerate(zip(cell_meta, per_cell))]


@register("engine")
class EngineExecutor(Executor):
    """The runtime FIFO queues (:class:`GossipEngine`): seeded transient
    link failures with retransmission; with a codec, real encoded payloads.

    The engine outlives the round, so a codec's error-feedback residuals
    persist across rounds, and is rebuilt on churn, like the schedule. The
    payloads are the reference's small deterministic proxies, on
    ``device`` (the card unless ``device="cpu"``; no card raises), while
    byte accounting stays analytic at the declared payload size."""

    supports_drops = True
    moves_payloads = True

    def __init__(self, device: DeviceLike = None) -> None:
        self.device = device

    def begin(self) -> None:
        self._device = resolve_device(self.device)

    def begin_epoch(self, mod: Moderator, members: Tuple[int, ...]) -> None:
        super().begin_epoch(mod, members)
        self._engine = GossipEngine(policy=self.policy, codec=self.codec)
        self._proxies = (_proxy_payloads(self.spec, members, self._device)
                         if self.codec is not None else None)

    def run_round(self, rctx: RoundContext) -> RoundReport:
        engine = self._engine
        engine.drop_fn = _drop_fn(self.spec, rctx.round_idx)
        first_report = len(engine.reports)
        n_slots = engine.run_round(rctx.round_idx, self._proxies)
        round_reports = engine.reports[first_report:]
        sent = sum(len(rep.sends) for rep in round_reports)
        drops = sum(len(rep.dropped) for rep in round_reports)
        attempted = sent + drops  # a dropped transfer still burned wire time
        return rctx.report(
            n_slots=n_slots, transmissions=attempted,
            bytes_mb=attempted * self.payload_mb * self.policy.payload_fraction,
            bytes_on_wire_mb=attempted * self.wire_send_mb, drops=drops)


@register("netsim")
class NetsimExecutor(Executor):
    """The contended fluid underlay (:func:`simulate_policy`) over the
    member-masked testbed, compiled once per epoch: the paper's Tables
    III-V metrics, every round simulated; the raw results go to
    ``ScenarioResult.sim_results``."""

    provides_timing = True

    def begin(self) -> None:
        self._sims: List[SimResult] = []

    def begin_epoch(self, mod: Moderator, members: Tuple[int, ...]) -> None:
        super().begin_epoch(mod, members)
        self._stats = self.cache.measure(self.spec, members, self.policy)
        self._testbed = as_network_model(_member_testbed(self.spec, members))

    def run_round(self, rctx: RoundContext) -> RoundReport:
        sim = simulate_policy(self.policy, self._testbed, self.payload_mb,
                              record_trace=self.record_trace, codec=self.codec)
        self._sims.append(sim)
        tx = sim.n_transfers
        return rctx.report(
            n_slots=self._stats["n_slots"], transmissions=tx,
            bytes_mb=tx * self.payload_mb * self.policy.payload_fraction,
            bytes_on_wire_mb=sim.bytes_on_wire_mb, total_time_s=sim.total_time_s,
            mean_transfer_s=sim.mean_transfer_s, mean_bandwidth_mbps=sim.mean_bandwidth_mbps,
            max_concurrency=sim.max_concurrency)

    def finish(self, result: ScenarioResult) -> ScenarioResult:
        result.sim_results = self._sims
        return result


@dataclass
class DeviceRoundReport:
    """One card round as the device executor saw it: the counts of its
    :class:`RoundReport`, and what only the card knows."""

    round: int
    members: List[int]
    n_slots: int
    transmissions: int
    bytes_mb: float
    bytes_on_wire_mb: float
    numerics_ok: Optional[bool]  # None: the codec has no deterministic bound
    finite: bool  # every output finite, in the input's shape
    device_ms: Optional[float]  # the round on the card (CUDA events); None on CPU

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclass
class ScenarioRun:
    """The card view of one device executor run (:attr:`DeviceExecutor.runs`)."""

    scenario: str
    device: str
    payload_mb: float
    elems_per_node: int
    rounds: List[DeviceRoundReport] = field(default_factory=list)
    # each membership epoch's device plan (MST, colors, permutation steps)
    plans: List[GossipPlan] = field(default_factory=list, repr=False)
    # the allocator's peak from the run's start to its end; None on the CPU
    peak_bytes: Optional[int] = None


def _params(n: int, elems: int, proxy: bool, seed: int, device: torch.device) -> torch.Tensor:
    if proxy:
        return torch.arange(n * elems, dtype=torch.float32, device=device).reshape(n, elems)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, elems), generator=gen, device=device)


def check_fedavg(out: torch.Tensor, w: torch.Tensor, members: Tuple[int, ...], mode: str,
                 bound: Optional[float], n: int) -> Tuple[Optional[bool], bool]:
    """(numerics_ok, finite), with the reference's jax executor's rule: live
    nodes within ``max(1e-5, bound·(1 or n))`` (+ rtol 1e-5) of the live
    nodes' f64 mean, masked nodes unchanged within 1e-6."""
    finite = out.shape == w.shape and bool(torch.isfinite(out).all())
    if bound is None:
        return None, finite
    mean = torch.zeros(w.shape[1], dtype=torch.float64, device=w.device)
    for m in members:
        mean += w[m].double()
    mean /= len(members)
    atol = max(1e-5, bound * (1 if mode == "dissemination" else n))
    ok = all(torch.allclose(out[m].double(), mean, rtol=1e-5, atol=atol)
             for m in members)
    if mode != "flooding":
        for m in sorted(set(range(n)) - set(members)):
            ok = ok and torch.allclose(out[m], w[m], rtol=1e-5, atol=1e-6)
    return ok, finite


def _timed_round(mode: str, plan: GossipPlan, w: torch.Tensor, codec,
                 dev: torch.device) -> Tuple[torch.Tensor, Optional[float]]:
    if dev.type != "cuda":
        return gossip_exchange(mode, plan, {"w": w}, codec=codec)["w"], None
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = gossip_exchange(mode, plan, {"w": w}, codec=codec)["w"]
    end.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(end)


@register("device")
class DeviceExecutor(Executor):
    """The gossip collectives on the card, churn-masked: each membership
    epoch's device plan (:func:`~repro_torch.dfl.session.plan_for_members`
    over the run's effective overlay: the declared graph, or the annealed
    one when the spec declares an optimizer) moves the nodes' (N, P) f32
    parameters along its permutation steps, and every live node must end
    at the live nodes' FedAvg (within the codec's bound) while masked nodes
    keep theirs. Flooding runs as an all-gather: every live node receives
    the other live nodes' models in one slot. Counts and bytes are the
    device plan's (:func:`~repro_torch.dfl.collectives.
    gossip_collective_bytes`), as the reference's ``jax`` executor reports
    them.

    ``proxy_elems=None`` moves the payload's full f32 size a node, drawn
    from ``seed``; ``proxy_elems=4`` is the reference's ``arange`` proxy.
    The card view of each run (each round's ``device_ms``, finite outputs,
    the epoch plans, the run's peak memory) is appended to :attr:`runs`, the
    last one is :attr:`run`; a traced run on the card counts the rounds'
    device time as ``device.round_ms``. The parameters are freed when a run
    ends, so a sweep's peak is its largest cell's."""

    provides_numerics = True
    moves_payloads = True

    def __init__(self, device: DeviceLike = None, proxy_elems: Optional[int] = None,
                 seed: int = 0) -> None:
        self.device = device
        self.proxy_elems = proxy_elems
        self.seed = seed
        self.runs: List[ScenarioRun] = []

    @property
    def run(self) -> Optional[ScenarioRun]:
        return self.runs[-1] if self.runs else None

    def begin(self) -> None:
        spec = self.spec
        self._device = resolve_device(self.device)
        self._mode = resolve_gossip_mode(spec.protocol)
        if self._mode == "flooding" and spec.churn:
            raise ValueError("the flooding collective (all-gather) cannot mask "
                             "churned nodes; use an MST mode for churn scenarios")
        if self._device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self._device)
        elems = self.proxy_elems or int(round(self.payload_mb * 1e6 / 4))
        self._w = _params(spec.n, elems, self.proxy_elems is not None, self.seed,
                          self._device)
        self._bound = (0.0 if self.codec is None
                       else self.codec.mean_atol(float(self._w.abs().max())))
        self.runs.append(ScenarioRun(spec.name, str(self._device), self.payload_mb, elems))

    def begin_epoch(self, mod: Moderator, members: Tuple[int, ...]) -> None:
        # the epoch's policy through the run's cache, as every executor takes it (the
        # plan verify proved); the card moves the device plan's permutation steps
        super().begin_epoch(mod, members)
        plan = plan_for_members(self.spec.n, members, n_segments=self.spec.n_segments,
                                full_graph=self.overlay)
        plan.prepare(self._device)  # index tensors on the card before the timed round
        self._plan = plan
        self.run.plans.append(plan)

    def run_round(self, rctx: RoundContext) -> RoundReport:
        mode, plan, members = self._mode, self._plan, rctx.members
        out, device_ms = _timed_round(mode, plan, self._w, self.codec, self._device)
        numerics_ok, finite = check_fedavg(out, self._w, members, mode, self._bound,
                                           self.spec.n)
        del out
        slot_plan = {"dissemination": plan.dissemination, "segmented": plan.segmented,
                     "tree_allreduce": plan.tree}.get(mode)
        if slot_plan is not None:
            n_slots, tx = slot_plan.n_slots, slot_plan.total_transmissions()
        else:  # flooding = the all-gather: every live node receives m - 1 models
            n_slots, tx = 1, len(members) * (len(members) - 1)
        param_bytes = self.payload_mb * 1e6
        bytes_mb = gossip_collective_bytes(mode, plan, param_bytes) / 1e6
        wire_mb = gossip_collective_bytes(mode, plan, param_bytes, codec=self.codec) / 1e6
        if device_ms is not None:
            obs.get().count("device.round_ms", device_ms)
        self.run.rounds.append(DeviceRoundReport(
            round=rctx.round_idx, members=list(members), n_slots=n_slots, transmissions=tx,
            bytes_mb=bytes_mb, bytes_on_wire_mb=wire_mb, numerics_ok=numerics_ok,
            finite=finite, device_ms=device_ms))
        return rctx.report(n_slots=n_slots, transmissions=tx, bytes_mb=bytes_mb,
                           bytes_on_wire_mb=wire_mb, numerics_ok=numerics_ok)

    def finish(self, result: ScenarioResult) -> ScenarioResult:
        self._w = None  # the next cell's parameters replace, not join, these
        if self._device.type == "cuda":
            self.run.peak_bytes = torch.cuda.max_memory_allocated(self._device)
        return result


@register("event")
class EventExecutor(Executor):
    """The discrete-event asynchronous engine (:mod:`repro_torch.core.events`):
    per-node virtual clocks over the same plan IR, a bounded-staleness
    admission window, seeded straggler compute, drops and churn at virtual
    timestamps.

    :meth:`run_round` only registers a round (members, the compiled member
    underlay, the epoch's slot arrays, each node's compute draw); the whole
    simulation runs in :meth:`finish`, which back-fills every report from
    the virtual clock, since overlapping rounds are final only when the
    heap drains. With ``max_staleness=0`` admission is a global barrier and
    the byte accounting equals the netsim executor's exactly;
    ``total_time_s`` is the round's inter-completion gap, so the rounds sum
    to the virtual makespan."""

    supports_drops = True
    provides_timing = True
    supports_staleness = True

    def begin(self) -> None:
        spec = self.spec
        self._engine = AsyncEventEngine(
            max_staleness=spec.max_staleness, drop_rate=spec.drop_rate,
            drop_seed=spec.drop_seed,
            record_events=self.record_trace or spec.record_events or obs.get().enabled)
        self._pending: List[Tuple[RoundReport, float, float]] = []

    def begin_epoch(self, mod: Moderator, members: Tuple[int, ...]) -> None:
        super().begin_epoch(mod, members)
        self._stats = self.cache.measure(self.spec, members, self.policy)
        self._slots = self.cache.slots(self.spec, members, self.policy)
        self._net = as_network_model(_member_testbed(self.spec, members))

    def run_round(self, rctx: RoundContext) -> RoundReport:
        spec = self.spec
        n = len(rctx.members)
        # straggler injection: a seeded uniform jitter a (round, node) on top
        # of the declared compute time
        compute = np.full(n, spec.compute_time_s)
        if spec.compute_jitter_s > 0:
            rng = np.random.default_rng([spec.jitter_seed, rctx.round_idx])
            compute = compute + rng.random(n) * spec.compute_jitter_s
        self._engine.add_round(rctx.members, self._net, self._slots, self.wire_send_mb,
                               compute)
        report = rctx.report(n_slots=self._stats["n_slots"], transmissions=0, bytes_mb=0.0)
        self._pending.append((report, self.wire_send_mb, self.policy.payload_fraction))
        return report

    def finish(self, result: ScenarioResult) -> ScenarioResult:
        timings = self._engine.run()
        rec = obs.get()
        prev_completed = 0.0
        for (report, wire_mb, fraction), rt in zip(self._pending, timings):
            tx = rt.attempts
            report.transmissions = tx
            report.drops = rt.drops
            # the netsim executor's operand order and the fluid simulator's
            # one float a transfer: staleness 0 equals it exactly
            report.bytes_mb = tx * self.payload_mb * fraction
            report.bytes_on_wire_mb = float(sum([wire_mb] * tx))
            report.total_time_s = rt.completed_s - prev_completed
            if rec.enabled:
                # the round's virtual span is its inter-completion gap, so the
                # rounds' spans sum to the scenario's total_time_s
                rec.add_span(f"round {report.round}", prev_completed, rt.completed_s,
                             track="rounds", cat="event-round",
                             args={"round": report.round, "total_time_s": report.total_time_s,
                                   "admitted_at_s": rt.admitted_s, "attempts": tx,
                                   "drops": rt.drops})
            prev_completed = rt.completed_s
            report.mean_transfer_s = rt.mean_transfer_s()
            report.mean_bandwidth_mbps = rt.mean_bandwidth_mbps()
            report.max_concurrency = rt.max_in_flight
            report.admitted_at_s = rt.admitted_s
            report.completed_at_s = rt.completed_s
            for ev in report.churn_applied:
                # churn takes effect when the window admits the round
                ev["applied_at_s"] = rt.admitted_s
        if rec.enabled:
            for s in self._engine.virtual_spans():
                rec.add_span(s["name"], s["t0"], s["t1"], track=s["track"], cat=s["cat"],
                             args=s["args"])
            rec.count("event.retries", sum(rt.drops for rt in timings))
            rec.gauge("event.makespan_s", prev_completed)
        return result
