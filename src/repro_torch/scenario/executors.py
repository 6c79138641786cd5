"""The counting part of ``repro.scenario.executors``: the moderator
lifecycle that every executor shares, the capability check, and the
``plan`` executor that counts a scenario's rounds.

:func:`membership_rounds` drives the paper's moderator lifecycle (III-A):
connectivity reports filed from the overlay, each round's churn applied,
an emergency election when the moderator itself left, the 2-node floor,
and a round-robin rotation after every round. :class:`PlanExecutor`
builds each membership epoch's policy over the moderator's member subgraph
(:func:`~repro_torch.core.plan.make_policy`), counts its slots and
transmissions (:func:`~repro_torch.core.plan.measure_policy`) and its
bytes through :func:`~repro_torch.compress.per_send_wire_mb`, with the
reference's operand order, so the numbers are bit-identical to the
reference's plan executor.

It has no timing: the reference fills its round times from an analytic
network model (``repro.core.network.TimingProfile``), which is not ported.
It declares ``counting_only`` and lacks ``supports_staleness``, so a spec
with straggler compute or a staleness window raises, as on the reference's
plan executor. A spec with an overlay optimizer raises by name: its plan is
built over the working overlay that only ``repro.opt``'s search computes.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

from ..compress.codec import per_send_wire_mb
from ..core.graph import Graph
from ..core.moderator import ConnectivityReport, Moderator
from ..core.plan import make_policy, measure_policy
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


class PlanExecutor:
    """Counting: each membership epoch's policy over the moderator's member
    subgraph, its slots and transmissions, and the bytes they carry."""

    name = "plan"
    supports_drops = False
    provides_timing = False
    provides_numerics = False
    moves_payloads = False
    counting_only = True
    supports_staleness = False

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

    def execute(self, spec: ScenarioSpec) -> ScenarioResult:
        spec.validate()
        self.check_capabilities(spec)
        if spec.optimizer is not None:
            raise ValueError(
                f"scenario {spec.name!r} declares an overlay optimizer: its plan needs "
                "repro.opt's annealed overlay, not ported")
        payload_mb, codec = spec.payload_mb(), spec.codec_obj()
        reports: List[RoundReport] = []
        epoch: Optional[Tuple[int, ...]] = None
        for r, mod, members, applied in membership_rounds(spec, spec.overlay_graph()):
            if tuple(members) != epoch:  # a new epoch: plan the member subgraph
                epoch = tuple(members)
                policy = make_policy(spec.protocol, mod.build_graph()[0],
                                     mst_algorithm=spec.mst_algorithm,
                                     coloring_algorithm=spec.coloring_algorithm,
                                     n_segments=spec.n_segments)
                stats = measure_policy(policy)
                wire_send_mb = per_send_wire_mb(codec, payload_mb, policy.payload_fraction)
            tx = stats["transmissions"]
            reports.append(RoundReport(
                round=r, protocol=spec.protocol, members=list(members),
                moderator=mod.moderator_id, n_slots=stats["n_slots"], transmissions=tx,
                bytes_mb=tx * payload_mb * policy.payload_fraction,
                bytes_on_wire_mb=tx * wire_send_mb,
                churn_applied=[ev.to_dict() for ev in applied]))
        return ScenarioResult(scenario=spec.name, executor=self.name, protocol=spec.protocol,
                              payload_mb=payload_mb, rounds=reports, spec=spec.to_dict())


# the port's executors by name (the reference also has engine, netsim, jax
# and event; repro_torch.scenario.runner runs a scenario's rounds on the card)
EXECUTORS = {"plan": PlanExecutor}


def get(name: str) -> PlanExecutor:
    """A fresh executor instance for ``name``."""
    try:
        return EXECUTORS[name]()
    except KeyError:
        raise ValueError(f"unknown executor {name!r}; the port has {sorted(EXECUTORS)} "
                         "(the engine, netsim, jax and event executors are not "
                         "ported)") from None
