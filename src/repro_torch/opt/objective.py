"""Objectives: the analytic cost oracle wrapped into scalar overlay scores
(the port's copy of ``repro.opt.objective``).

An :class:`Objective` maps a candidate overlay edit to a scalar (lower is
better) *without ever running a simulator*: round time comes from
:func:`repro_torch.core.network.estimate_timing`'s closed form, steady-state
throughput from :func:`~repro_torch.core.network.estimate_throughput`, and byte
totals from the profile walk's transmission counts — all at counting speed,
which is what makes the oracle cheap enough for an inner search loop.

The evaluation must score exactly what the scenario stack will later run:
the policy is built the way :meth:`repro_torch.scenario.cache.PlanCache.
sparse_policy` builds it (the member MST + colors, recolored with the
scenario's coloring algorithm when it is not the planner's native
Jones–Plassmann; flooding-family protocols run on the member-induced
working subgraph instead of the tree), and per-send wire bytes go through
:func:`repro_torch.compress.per_send_wire_mb` — the same formula every executor
uses. An optimizer win claimed from these scores must be *confirmed* by the
fluid simulator before it is reported (the ``optimized_vs_mst`` sweep on
the ``netsim`` executor).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Protocol, Tuple

from ..compress import Codec, per_send_wire_mb
from ..core.graph import color_graph
from ..core.network import (
    CompiledNetwork,
    TimingProfile,
    as_compiled_network,
    estimate_throughput,
)
from ..core.plan import CommPolicy, make_policy
from .state import Candidate

__all__ = [
    "OBJECTIVES",
    "EvalContext",
    "Objective",
    "context_for_scenario",
    "make_objective",
]

_FLOOD_PROTOCOLS = ("flooding", "broadcast", "broadcast_exchange")


class Objective(Protocol):
    """The objective protocol: score a candidate edit, lower is better.

    Implementations must be deterministic and side-effect free — the search
    strategies assume a candidate's score never changes between proposal
    and commit.
    """

    def __call__(self, cand: Candidate, ctx: "EvalContext") -> float:
        ...  # pragma: no cover - protocol


@dataclass
class EvalContext:
    """Everything a score needs beyond the candidate itself.

    ``network`` is the compiled underlay already masked to the member set;
    the payload/codec/protocol fields mirror the scenario spec so the
    objective prices exactly the policy the executors will build.
    """

    network: CompiledNetwork
    payload_mb: float = 21.2
    codec: Optional[Codec] = None
    protocol: str = "mosgu"
    n_segments: int = 4
    coloring_algorithm: str = "bfs"
    max_staleness: int = 0
    compute_time_s: float = 0.0
    compute_jitter_s: float = 0.0
    # blend weights (the "blend" objective): seconds, megabytes and
    # steady-state period are mixed linearly
    w_time: float = 1.0
    w_bytes: float = 0.0
    w_period: float = 0.0

    def policy_for(self, cand: Candidate) -> CommPolicy:
        """The policy the scenario stack would build over this candidate —
        the single place the objective layer constructs policies, so the
        oracle can never price a different schedule than the executors run.
        """
        if self.protocol in _FLOOD_PROTOCOLS:
            return make_policy(self.protocol, cand.member_subgraph())
        mst, colors = cand.plan.member_mst()
        if self.coloring_algorithm != "jones_plassmann":
            colors = color_graph(mst, self.coloring_algorithm)
        return make_policy(self.protocol, mst, mst=mst, colors=colors,
                           n_segments=self.n_segments)

    def profile_for(self, cand: Candidate) -> Tuple[TimingProfile, float]:
        """(timing profile, per-send wire MB) for a candidate — one policy
        walk per evaluation, shared by every metric a blend needs."""
        pol = self.policy_for(cand)
        profile = TimingProfile.from_policy(pol, self.network)
        wire_mb = per_send_wire_mb(self.codec, self.payload_mb,
                                   pol.payload_fraction)
        return profile, wire_mb


def _round_time(cand: Candidate, ctx: EvalContext) -> float:
    profile, wire_mb = ctx.profile_for(cand)
    return float(profile.estimate(wire_mb).total_time_s)


def _total_bytes(cand: Candidate, ctx: EvalContext) -> float:
    profile, wire_mb = ctx.profile_for(cand)
    return float(profile.measure_stats()["transmissions"]) * wire_mb


def _throughput(cand: Candidate, ctx: EvalContext) -> float:
    """Staleness-aware steady-state period (s/round) — lower is faster."""
    pol = ctx.policy_for(cand)
    wire_mb = per_send_wire_mb(ctx.codec, ctx.payload_mb,
                               pol.payload_fraction)
    est = estimate_throughput(
        pol, ctx.network, wire_mb * 1e6,
        max_staleness=ctx.max_staleness,
        compute_time_s=ctx.compute_time_s,
        compute_jitter_s=ctx.compute_jitter_s)
    return float(est.steady_period_s)


def _blend(cand: Candidate, ctx: EvalContext) -> float:
    profile, wire_mb = ctx.profile_for(cand)
    score = 0.0
    if ctx.w_time:
        score += ctx.w_time * float(profile.estimate(wire_mb).total_time_s)
    if ctx.w_bytes:
        score += ctx.w_bytes * (
            float(profile.measure_stats()["transmissions"]) * wire_mb)
    if ctx.w_period:
        score += ctx.w_period * _throughput(cand, ctx)
    return score


def _tree_cost(cand: Candidate, ctx: EvalContext) -> float:
    """The paper's own criterion (MST edge-cost sum) — the degenerate
    objective that reproduces plain MST planning, useful as a baseline."""
    return cand.plan.tree_cost()


OBJECTIVES: Dict[str, Callable[[Candidate, EvalContext], float]] = {
    "round_time": _round_time,
    "total_bytes": _total_bytes,
    "throughput": _throughput,
    "blend": _blend,
    "tree_cost": _tree_cost,
}


def make_objective(name: str) -> Callable[[Candidate, EvalContext], float]:
    try:
        return OBJECTIVES[name]
    except KeyError:
        raise ValueError(f"unknown objective {name!r}; known: "
                         f"{sorted(OBJECTIVES)}") from None


def context_for_scenario(spec, members=None) -> EvalContext:
    """An :class:`EvalContext` priced exactly like a scenario run.

    ``spec`` is duck-typed on the :class:`~repro_torch.scenario.spec.ScenarioSpec`
    surface (``testbed()``, ``payload_mb()``, ``codec_obj()``, protocol and
    async fields) so :mod:`repro_torch.opt` never imports the scenario layer.
    """
    underlay = spec.testbed()
    if members is not None:
        members = sorted(members)
        if len(members) != spec.n or list(members) != list(range(spec.n)):
            underlay = underlay.masked(members)
    net = as_compiled_network(underlay, n=spec.n)
    opt = spec.optimizer
    return EvalContext(
        network=net,
        payload_mb=spec.payload_mb(),
        codec=spec.codec_obj(),
        protocol=spec.protocol,
        n_segments=spec.n_segments,
        coloring_algorithm=spec.coloring_algorithm,
        max_staleness=getattr(opt, "max_staleness", 0) or spec.max_staleness,
        compute_time_s=(getattr(opt, "compute_time_s", 0.0)
                        or spec.compute_time_s),
        compute_jitter_s=spec.compute_jitter_s,
        w_time=getattr(opt, "w_time", 1.0),
        w_bytes=getattr(opt, "w_bytes", 0.0),
        w_period=getattr(opt, "w_period", 0.0),
    )
