"""The port's ``repro.scenario.executors``: the moderator lifecycle that
every executor shares, the capability check, and the two executors that
run a scenario's rounds on the host.

:func:`membership_rounds` drives the paper's moderator lifecycle (III-A):
connectivity reports filed from the overlay, each round's churn applied,
an emergency election when the moderator itself left, the 2-node floor,
and a round-robin rotation after every round. :class:`Executor.execute`
builds each membership epoch's policy over the moderator's member subgraph
(:func:`~repro_torch.core.plan.make_policy`) and its per-send wire size
(:func:`~repro_torch.compress.per_send_wire_mb`), then reports every round:

=========  ================================================================
plan       counting: slots, transmissions and bytes, and the round times of
           the analytic network model (:class:`~repro_torch.core.network.
           TimingProfile` over the member-masked underlay, built once per
           membership epoch; its walk also counts the slots and
           transmissions) (``counting_only``, ``provides_timing``)
netsim     the contended fluid underlay
           (:func:`~repro_torch.core.netsim.simulate_policy`), every round
           simulated: the paper's Tables III-V metrics (``provides_timing``)
=========  ================================================================

Bytes take the reference's operand order, so every number equals the
reference executor's. Neither has ``supports_staleness``: a spec with
straggler compute or a staleness window raises, as on the reference's plan
and netsim executors. A spec with an overlay optimizer raises by name: its
plan is built over the working overlay that only ``repro.opt``'s search
computes. Not ported: the reference's engine, jax and event executors
(:mod:`repro_torch.scenario.runner` runs a scenario's rounds on the card,
the jax executor's counterpart) and its ``PlanCache``, which only buys
speed across sweep cells.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple, Union

from ..compress.codec import Codec, per_send_wire_mb
from ..core.graph import Graph
from ..core.moderator import ConnectivityReport, Moderator
from ..core.netsim import SimResult, TestbedSpec, simulate_policy
from ..core.network import NetworkSpec, TimingProfile, as_network_model
from ..core.plan import CommPolicy, make_policy, measure_policy
from .spec import (CAPABILITY_FLAGS, ChurnEvent, RoundReport, ScenarioResult, ScenarioSpec,
                   applicable_churn)


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


def membership_rounds(spec: ScenarioSpec, overlay: Graph
                      ) -> Iterator[Tuple[int, Moderator, List[int], List[ChurnEvent]]]:
    """Yields ``(round_idx, moderator, members, applied_churn)`` after the
    round's churn, the emergency election and the 2-node floor; rotates the
    moderator when control returns."""
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


class Executor:
    """One host executor: capability flags, the lifecycle in
    :meth:`execute`, and two hooks, :meth:`begin_epoch` (membership
    changed) and :meth:`run_round`."""

    name = "abstract"
    supports_drops = False
    provides_timing = False
    provides_numerics = False
    moves_payloads = False
    counting_only = False
    supports_staleness = False

    spec: ScenarioSpec
    payload_mb: float
    codec: Optional[Codec]
    policy: CommPolicy
    wire_send_mb: float

    def check_capabilities(self, spec: ScenarioSpec) -> None:
        """Fail when the spec needs a capability this executor lacks, naming
        it, why the spec needs it and the executors that have it."""
        missing = [(flag, why) for flag, why in required_capabilities(spec)
                   if not getattr(self, flag)]
        if not missing:
            return
        providers = sorted(n for n, cls in EXECUTORS.items()
                           if all(getattr(cls, flag) for flag, _ in missing))
        reasons = "; ".join(f"{flag!r} ({why})" for flag, why in missing)
        raise ValueError(
            f"executor {self.name!r} lacks capability {reasons} required by "
            f"scenario {spec.name!r}; executors providing "
            f"{'it' if len(missing) == 1 else 'them all'}: {providers}")

    def begin_epoch(self, mod: Moderator, members: Tuple[int, ...]) -> None:
        """The epoch's policy over the moderator's member subgraph and its
        per-send wire size."""
        spec = self.spec
        self.policy = make_policy(spec.protocol, mod.build_graph()[0],
                                  mst_algorithm=spec.mst_algorithm,
                                  coloring_algorithm=spec.coloring_algorithm,
                                  n_segments=spec.n_segments)
        self.wire_send_mb = per_send_wire_mb(self.codec, self.payload_mb,
                                             self.policy.payload_fraction)

    def run_round(self) -> dict:
        """The round's counted and timed fields of its :class:`RoundReport`."""
        raise NotImplementedError

    def finish(self, result: ScenarioResult) -> ScenarioResult:
        return result

    def execute(self, spec: ScenarioSpec) -> ScenarioResult:
        spec.validate()
        self.check_capabilities(spec)
        if spec.optimizer is not None:
            raise ValueError(
                f"scenario {spec.name!r} declares an overlay optimizer: its plan needs "
                "repro.opt's annealed overlay, not ported")
        self.spec = spec
        self.payload_mb, self.codec = spec.payload_mb(), spec.codec_obj()
        reports: List[RoundReport] = []
        epoch: Optional[Tuple[int, ...]] = None
        for r, mod, members, applied in membership_rounds(spec, spec.overlay_graph()):
            if tuple(members) != epoch:
                epoch = tuple(members)
                self.begin_epoch(mod, epoch)
            reports.append(RoundReport(
                round=r, protocol=spec.protocol, members=list(members),
                moderator=mod.moderator_id, churn_applied=[ev.to_dict() for ev in applied],
                **self.run_round()))
        return self.finish(ScenarioResult(
            scenario=spec.name, executor=self.name, protocol=spec.protocol,
            payload_mb=self.payload_mb, rounds=reports, spec=spec.to_dict()))


class PlanExecutor(Executor):
    """Counting and the analytic round times: each epoch's
    :class:`TimingProfile` over the member-masked underlay, evaluated at the
    epoch's per-send wire size; its walk gives the slot and transmission
    counts (``measure_stats``, the reference's seed of its measure cache)."""

    name = "plan"
    counting_only = True
    provides_timing = True

    def begin_epoch(self, mod: Moderator, members: Tuple[int, ...]) -> None:
        super().begin_epoch(mod, members)
        profile = TimingProfile.from_policy(self.policy, _member_testbed(self.spec, members))
        self._stats = profile.measure_stats()
        self._timing = profile.estimate(self.wire_send_mb)

    def run_round(self) -> dict:
        tx, est = self._stats["transmissions"], self._timing
        return dict(n_slots=self._stats["n_slots"], transmissions=tx,
                    bytes_mb=tx * self.payload_mb * self.policy.payload_fraction,
                    bytes_on_wire_mb=tx * self.wire_send_mb,
                    total_time_s=est.total_time_s, mean_transfer_s=est.mean_transfer_s,
                    mean_bandwidth_mbps=est.mean_bandwidth_mbps,
                    max_concurrency=est.max_concurrency)


class NetsimExecutor(Executor):
    """The contended fluid underlay (:func:`simulate_policy`) over the
    member-masked testbed, compiled once per epoch: the paper's Tables
    III-V metrics, every round simulated; the raw results go to
    ``ScenarioResult.sim_results``."""

    name = "netsim"
    provides_timing = True

    def execute(self, spec: ScenarioSpec) -> ScenarioResult:
        self._sims: List[SimResult] = []
        return super().execute(spec)

    def begin_epoch(self, mod: Moderator, members: Tuple[int, ...]) -> None:
        super().begin_epoch(mod, members)
        self._stats = measure_policy(self.policy)
        self._testbed = as_network_model(_member_testbed(self.spec, members))

    def run_round(self) -> dict:
        sim = simulate_policy(self.policy, self._testbed, self.payload_mb, codec=self.codec)
        self._sims.append(sim)
        tx = sim.n_transfers
        return dict(n_slots=self._stats["n_slots"], transmissions=tx,
                    bytes_mb=tx * self.payload_mb * self.policy.payload_fraction,
                    bytes_on_wire_mb=sim.bytes_on_wire_mb, total_time_s=sim.total_time_s,
                    mean_transfer_s=sim.mean_transfer_s,
                    mean_bandwidth_mbps=sim.mean_bandwidth_mbps,
                    max_concurrency=sim.max_concurrency)

    def finish(self, result: ScenarioResult) -> ScenarioResult:
        result.sim_results = self._sims
        return result


# the port's host executors by name (repro_torch.scenario.runner runs a
# scenario's rounds on the card)
EXECUTORS = {"plan": PlanExecutor, "netsim": NetsimExecutor}


def get(name: str) -> Executor:
    """A fresh executor instance for ``name``."""
    try:
        return EXECUTORS[name]()
    except KeyError:
        raise ValueError(f"unknown executor {name!r}; the port has {sorted(EXECUTORS)} "
                         "(the engine, jax and event executors are not ported; "
                         "repro_torch.scenario.runner runs a scenario on the card)") from None
