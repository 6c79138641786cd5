"""Cross-cell plan cache: MST + coloring + policy computed once per unique
member subgraph, shared by every executor and by :func:`run_sweep` (the
port's copy of ``repro.scenario.cache``: the same stages, keys and
counters).

A sweep is a grid of :class:`~repro_torch.scenario.spec.ScenarioSpec` cells that
mostly *share* their communication structure: a payload x codec grid over
one topology has 32 cells but exactly one MST/coloring/policy, and even a
topology x protocol grid only has as many unique plans as unique
``(member set, overlay, protocol, n_segments)`` combinations. Before the
sweep API every cell recomputed all of it.

:class:`PlanCache` memoizes the deterministic stages:

=============  ==========================================================
stage          key
=============  ==========================================================
overlay graph  overlay fingerprint (TopologySpec fields | matrix bytes)
member         (overlay, member set) — the moderator-built dense subgraph
subgraph
policy         (overlay, members, protocol, n_segments, mst/coloring
               algorithm, first color) — ``make_policy`` output
measure        policy key — ``measure_policy`` slot/transmission counts
slots          policy key — per-slot (src, dst) arrays for the event engine
timing         (policy key, underlay fingerprint) — the analytic
               :class:`~repro_torch.core.network.TimingProfile` (payload-
               independent; evaluated per wire size)
member plan    (overlay, members, mst/coloring algorithm) — the sparse
               :class:`~repro_torch.core.replan.MemberPlan`; misses repair the
               previous epoch's plan incrementally when one exists
=============  ==========================================================

Cached :class:`~repro_torch.core.plan.CommPolicy` objects are stateful but every
consumer (``measure_policy``, ``simulate_policy``, ``GossipEngine``) resets
them before use, so sequential sharing is safe; results are bit-identical
to a cold build. Hit/miss counters per
stage make cache effectiveness a first-class, testable metric.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Dict, Optional, Tuple

import numpy as np

from .. import obs
from ..core.graph import MST_ALGORITHMS, Graph, TopologySpec, color_graph
from ..core.network import TimingProfile, _field_tuple, underlay_fingerprint
from ..core.plan import CommPolicy, make_policy, measure_policy
from ..core.replan import MemberPlan, SparsePlanner
from ..core.sparse import CSRGraph

if TYPE_CHECKING:  # pragma: no cover
    from .spec import ScenarioSpec

PolicyKey = Tuple[Any, ...]


def _base_overlay_fingerprint(spec: "ScenarioSpec") -> Tuple[Any, ...]:
    """Identity of the *declared* overlay alone (optimizer-blind) — the key
    of the raw overlay-graph stage, which optimized and unoptimized cells
    deliberately share."""
    ov = spec.overlay
    if isinstance(ov, TopologySpec):
        return ("topo",) + _field_tuple(ov)
    a = np.asarray(ov, dtype=np.float64)
    return ("matrix", a.shape, a.tobytes())


def overlay_fingerprint(spec: "ScenarioSpec") -> Tuple[Any, ...]:
    """A hashable identity for a scenario's *effective* overlay.

    A :class:`TopologySpec` is identified by its field values (generation is
    deterministic given the spec); an explicit cost matrix by its exact
    bytes, so two numerically identical matrices share cache entries.
    (Flat ``_field_tuple`` rather than ``dataclasses.astuple`` — the
    deepcopy recursion inside ``astuple`` dominated sweep-grid key
    building.)

    When the spec declares an :class:`~repro_torch.opt.OptimizerSpec`, the
    executors run on the optimizer's working subgraph — which depends on the
    optimizer fields *and* everything its objective prices (underlay,
    protocol, segmentation, payload, codec, coloring). All of that is folded
    into the fingerprint so downstream stages (subgraph, policy, member
    plan, trajectory) can never collide with the unoptimized cell or with a
    differently-optimized sibling in the same sweep.
    """
    base = _base_overlay_fingerprint(spec)
    opt = spec.optimizer
    if opt is None:
        return base
    return base + ("opt",) + _field_tuple(opt) + (
        underlay_fingerprint(spec.testbed(), spec.n), spec.protocol,
        spec.n_segments, str(spec.payload), spec.codec,
        spec.coloring_algorithm)


def policy_key(spec: "ScenarioSpec",
               members: Tuple[int, ...]) -> PolicyKey:
    """The cache identity of one membership epoch's communication plan."""
    return (overlay_fingerprint(spec), members, spec.protocol,
            spec.n_segments, spec.mst_algorithm, spec.coloring_algorithm)


class PlanCache:
    """Memoizes overlay -> subgraph -> policy -> counting stats.

    One instance may span many :func:`run_scenario` calls (that is the point
    — :func:`run_sweep` threads one cache through every cell); a fresh
    instance per call reproduces the historical cold-build behaviour
    exactly.
    """

    def __init__(self) -> None:
        self._overlays: Dict[Tuple[Any, ...], Graph] = {}
        self._opts: Dict[Tuple[Any, ...], Any] = {}
        self._subgraphs: Dict[Tuple[Any, ...], Graph] = {}
        self._policies: Dict[PolicyKey, CommPolicy] = {}
        self._measures: Dict[PolicyKey, Dict[str, float]] = {}
        self._trajectories: Dict[Tuple[Any, ...], list] = {}
        self._slots: Dict[PolicyKey, list] = {}
        self._timings: Dict[Tuple[Any, ...], TimingProfile] = {}
        self._member_plans: Dict[Tuple[Any, ...], MemberPlan] = {}
        self._planners: Dict[Tuple[Any, ...], SparsePlanner] = {}
        self._latest_plan: Dict[Tuple[Any, ...], MemberPlan] = {}
        self._verifieds: Dict[Tuple[Any, ...], Any] = {}
        self.counters: Dict[str, int] = {
            "overlay_hits": 0, "overlay_misses": 0,
            "opt_hits": 0, "opt_misses": 0,
            "subgraph_hits": 0, "subgraph_misses": 0,
            "policy_hits": 0, "policy_misses": 0,
            "measure_hits": 0, "measure_misses": 0,
            "slots_hits": 0, "slots_misses": 0,
            "trajectory_hits": 0, "trajectory_misses": 0,
            "timing_hits": 0, "timing_misses": 0,
            "replan_hits": 0, "replan_misses": 0,
            "replan_incremental": 0, "replan_full": 0,
            "verified_hits": 0, "verified_misses": 0,
        }

    # -- accounting helpers --------------------------------------------------
    # every lookup goes through _memo (or, for the two-outcome replan stage,
    # _bump), so "each lookup increments exactly one of {stage}_hits /
    # {stage}_misses" is structural rather than a per-call-site convention
    def _bump(self, name: str) -> None:
        self.counters[name] += 1

    def _memo(self, stage: str, store: Dict, key, build: Callable[[], Any]):
        """One cache lookup: hit returns the stored value, miss runs
        ``build()`` (under a plan span when a recorder is active), stores
        and returns it. The single place hit/miss counters are maintained."""
        cached = store.get(key)
        if cached is not None:
            self._bump(stage + "_hits")
            return cached
        self._bump(stage + "_misses")
        rec = obs.get()
        if rec.enabled:
            with rec.span(f"{stage} build", cat="plan", track="cache",
                          stage=stage):
                cached = build()
        else:
            cached = build()
        store[key] = cached
        return cached

    # -- stages --------------------------------------------------------------
    def overlay(self, spec: "ScenarioSpec") -> Graph:
        """The scenario's *effective* overlay: the declared graph, or — when
        ``spec.optimizer`` is set — the analytic-cost-optimized working
        subgraph the ``opt`` stage builds over it (one search per unique
        (overlay, optimizer, pricing-context) fingerprint; every executor
        and sweep cell sharing the fingerprint reuses the result)."""
        base = self._memo("overlay", self._overlays,
                          _base_overlay_fingerprint(spec),
                          spec.overlay_graph)
        if spec.optimizer is None:
            return base

        def build():
            from ..opt import optimize_for_scenario  # lazy: opt is optional

            return optimize_for_scenario(spec, base_overlay=base).overlay

        return self._memo("opt", self._opts, overlay_fingerprint(spec),
                          build)

    def subgraph(self, spec: "ScenarioSpec", members: Tuple[int, ...],
                 build) -> Graph:
        """The moderator-built dense member subgraph; ``build()`` computes it
        on a miss (it is a pure function of (overlay, member set): reports
        are filed symmetrically from the overlay's cost matrix)."""
        return self._memo("subgraph", self._subgraphs,
                          (overlay_fingerprint(spec), members), build)

    def policy(self, spec: "ScenarioSpec", members: Tuple[int, ...],
               build_subgraph) -> CommPolicy:
        """``make_policy`` over the member subgraph, computed once per key."""

        def build() -> CommPolicy:
            g_sub = self.subgraph(spec, members, build_subgraph)
            return make_policy(
                spec.protocol, g_sub,
                mst_algorithm=spec.mst_algorithm,
                coloring_algorithm=spec.coloring_algorithm,
                n_segments=spec.n_segments)

        return self._memo("policy", self._policies,
                          policy_key(spec, members), build)

    def measure(self, spec: "ScenarioSpec", members: Tuple[int, ...],
                pol: Optional[CommPolicy] = None,
                stats: Optional[Dict[str, float]] = None) -> Dict[str, float]:
        """Cached ``measure_policy`` counts for one epoch's policy.

        ``stats`` seeds a miss with already-computed counts (e.g. a
        :meth:`~repro_torch.core.network.TimingProfile.measure_stats` from the
        timing walk) so consumers needing timing *and* counts walk the
        policy once."""
        def build() -> Dict[str, float]:
            if stats is not None:
                return stats
            if pol is not None:
                return measure_policy(pol)
            raise ValueError("measure miss needs the policy to count")

        return self._memo("measure", self._measures,
                          policy_key(spec, members), build)

    def slots(self, spec: "ScenarioSpec", members: Tuple[int, ...],
              pol: CommPolicy) -> list:
        """Cached per-slot ``(src, dst)`` arrays for the event engine
        (:func:`repro_torch.core.events.policy_slots`). One policy walk per unique
        plan — every round of an epoch, and every cell sharing the plan,
        replays the same arrays."""
        from ..core.events import policy_slots

        return self._memo("slots", self._slots, policy_key(spec, members),
                          lambda: policy_slots(pol))

    def timing(self, spec: "ScenarioSpec", members: Tuple[int, ...],
               underlay, build) -> TimingProfile:
        """Cached analytic :class:`~repro_torch.core.network.TimingProfile` for one
        epoch's plan on one underlay. The profile is payload-independent —
        a payload x codec grid over one plan shares a single profile and
        only re-evaluates the closed form per wire size. ``underlay`` is the
        member-masked underlay spec the profile was (or will be) built on;
        ``build()`` walks the policy on a miss."""
        key = (policy_key(spec, members),
               underlay_fingerprint(underlay, spec.n))
        return self._memo("timing", self._timings, key, build)

    def member_plan(self, spec: "ScenarioSpec", members: Tuple[int, ...],
                    overlay: CSRGraph) -> MemberPlan:
        """Sparse MST + Jones–Plassmann plan for one membership epoch.

        This is the incremental-replanning stage: one
        :class:`~repro_torch.core.replan.SparsePlanner` lives per (overlay,
        algorithms) key, and the *latest* plan built on it seeds a churn
        repair (``replan``) instead of a from-scratch build whenever the
        epoch's member set is new. ``replan_incremental`` vs
        ``replan_full`` counts how often the repair path actually ran.
        """
        if spec.mst_algorithm not in MST_ALGORITHMS:
            raise ValueError(f"unknown MST algorithm {spec.mst_algorithm!r}")
        key = (overlay_fingerprint(spec), members,
               spec.mst_algorithm, spec.coloring_algorithm)
        pkey = key[:1] + key[2:]

        def build() -> MemberPlan:
            planner = self._planners.get(pkey)
            if planner is None:
                planner = self._planners[pkey] = SparsePlanner(overlay)
            prev = self._latest_plan.get(pkey)
            rec = obs.get()
            if prev is not None:
                self._bump("replan_incremental")
                if rec.enabled:
                    with rec.span("replan incremental", cat="plan",
                                  track="cache", members=len(members)):
                        plan = planner.replan(prev, members)
                else:
                    plan = planner.replan(prev, members)
            else:
                self._bump("replan_full")
                if rec.enabled:
                    with rec.span("replan full", cat="plan", track="cache",
                                  members=len(members)):
                        plan = planner.plan(members)
                else:
                    plan = planner.plan(members)
            self._latest_plan[pkey] = plan
            return plan

        return self._memo("replan", self._member_plans, key, build)

    def sparse_policy(self, spec: "ScenarioSpec", members: Tuple[int, ...],
                      overlay: CSRGraph) -> CommPolicy:
        """``make_policy`` over a sparse overlay — no dense subgraph is ever
        materialized. MST protocols consume the :meth:`member_plan` tree and
        colors (recoloring with the requested algorithm when it is not the
        planner's native Jones–Plassmann); flooding runs on the member-
        induced CSR subgraph directly."""
        def build() -> CommPolicy:
            if spec.protocol in ("flooding", "broadcast", "broadcast_exchange"):
                return make_policy(spec.protocol, overlay.subgraph(members))
            plan = self.member_plan(spec, members, overlay)
            mst, colors = plan.member_mst()
            if spec.coloring_algorithm != "jones_plassmann":
                colors = color_graph(mst, spec.coloring_algorithm)
            return make_policy(spec.protocol, mst, mst=mst, colors=colors,
                               n_segments=spec.n_segments)

        return self._memo("policy", self._policies,
                          policy_key(spec, members), build)

    def verified(self, key: Tuple[Any, ...], build: Callable[[], Any]):
        """Cached static-verification certificate for one epoch's plan: a
        plain memo, ``build()`` being the caller's verifier. The key folds
        everything the verdict depends on (plan identity, payload, codec,
        underlay fingerprint, rounds, staleness window), so a plan verified
        once is never re-verified across runs sharing this cache. A failed
        verification raises out of ``build`` and caches nothing."""
        return self._memo("verified", self._verifieds, key, build)

    def trajectory(self, spec: "ScenarioSpec", build) -> list:
        """Cached membership trajectory: ``(round, moderator, members,
        applied_churn)`` per round. Depends only on (overlay, rounds, churn)
        — not on protocol or payload — so a payload x codec grid replays the
        moderator lifecycle once. ``build()`` must also file each epoch's
        member subgraph via :meth:`subgraph` so hits never need a moderator.
        """
        key = (overlay_fingerprint(spec), spec.rounds, spec.churn)
        return self._memo("trajectory", self._trajectories, key, build)

    # -- accounting ----------------------------------------------------------
    def snapshot(self) -> Dict[str, int]:
        """An immutable copy of the per-stage counters, cheap enough to take
        per scenario — the obs layer diffs entry/exit snapshots into each
        result's RunReport cache delta."""
        return dict(self.counters)

    def reset(self) -> None:
        """Zero the counters in place; cached artifacts are kept (resetting
        accounting between sweep phases must not force rebuilds)."""
        for k in self.counters:
            self.counters[k] = 0

    def stats(self) -> Dict[str, int]:
        out = dict(self.counters)
        out["unique_overlays"] = len(self._overlays)
        out["unique_subgraphs"] = len(self._subgraphs)
        out["unique_policies"] = len(self._policies)
        out["unique_timing_profiles"] = len(self._timings)
        out["unique_member_plans"] = len(self._member_plans)
        return out
