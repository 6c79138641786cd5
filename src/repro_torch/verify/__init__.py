"""Static plan verification: prove schedule safety, progress, and byte
conservation *before* anything runs (the port's copy of ``repro.verify``:
the same checkers, in the same order, with the same certificates).

The MST + coloring efficiency claim of the paper rests on the compiled
schedule being conflict-free; with four host executors, the card executor,
an incremental replanner and an overlay optimizer all producing/consuming
the same plan IR, that property deserves a proof at counting speed rather
than a simulator run and a hopeful assertion. This package analyzes a
frozen plan — one emit/commit walk, no executor — and returns a
:class:`~repro_torch.verify.invariants.Certificate` naming exactly which
invariant classes were proven (:data:`~repro_torch.verify.invariants.
INVARIANT_CLASSES`) and which were skipped, with reasons.

Entry points:

* :func:`verify_policy` / :func:`verify_plan` — one plan, one certificate.
* :func:`verify_scenario_plans` — every membership epoch of a declared
  :class:`~repro_torch.scenario.spec.ScenarioSpec`, sharing (and warming)
  the same :class:`~repro_torch.scenario.cache.PlanCache` the executors
  use; a plan verified once is never re-verified (the cache's ``verified``
  stage).
* :func:`verify_result` — recheck an executed scenario's byte accounting
  against the static wire model: an executor's
  :class:`~repro_torch.scenario.spec.ScenarioResult` or the device
  executor's card view, :class:`~repro_torch.scenario.executors.ScenarioRun`.
* ``run_scenario(spec, executor=..., verify="strict"|"warn"|"off")`` —
  calls :func:`verify_scenario_plans` on the run's own cache before the
  first round, so a violating plan never reaches the card (or a host
  executor). ``"off"`` (the default) does not even import this package.
* ``python -m repro_torch.verify --all`` — the conformance gate over every
  registry scenario and gated sweep cell; ``--lint`` runs the determinism
  lint (:mod:`repro_torch.verify.lint`) over ``src/repro_torch``.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Tuple

from .invariants import (
    INVARIANT_CLASSES,
    Certificate,
    PlanFacts,
    VerificationError,
    _Skip,
    admission_edges,
    check_admission_acyclic,
    check_admission_schedule,
    check_capacity,
    check_color_discipline,
    check_conservation,
    check_degree_cap,
    check_edges_in_graph,
    check_half_duplex,
    check_node_range,
    check_progress,
    check_proper_coloring,
    check_report_conservation,
    recompute_wire_mb,
)

VERIFY_MODES = ("off", "warn", "strict")

__all__ = [
    "Certificate", "INVARIANT_CLASSES", "PlanFacts", "VERIFY_MODES",
    "VerificationError", "VerificationWarning", "admission_edges",
    "check_admission_acyclic", "check_admission_schedule", "verify_facts",
    "verify_plan", "verify_policy", "verify_result",
    "verify_scenario_plans",
]


class VerificationWarning(UserWarning):
    """``mode="warn"``: a plan failed verification but execution proceeds."""


def verify_facts(facts: PlanFacts, network=None,
                 payload_mb: Optional[float] = None, codec=None,
                 rounds: int = 1, max_staleness: int = 0,
                 plan=None,
                 expected_stats: Optional[Dict[str, float]] = None
                 ) -> Certificate:
    """Run every applicable invariant checker over one frozen plan.

    Raises :class:`VerificationError` on the first violation (checkers run
    in the documented order, so rejection tests can rely on which
    invariant names a given defect); inapplicable checks are recorded in
    ``Certificate.skipped`` with the reason, never silently dropped.
    """
    cert = Certificate(kind=facts.kind, n=facts.n, n_slots=facts.n_slots,
                       transmissions=facts.transmissions)

    def ran(name: str) -> None:
        cert.invariants.append(name)

    check_node_range(facts)
    ran("structure/node-range")

    if facts.graph is not None:
        check_edges_in_graph(facts)
        ran("structure/edges-in-graph")
    elif facts.kind == "broadcast_exchange":
        cert.skipped["structure/edges-in-graph"] = (
            "broadcast runs on the complete graph (no edge universe)")
    else:
        cert.skipped["structure/edges-in-graph"] = (
            "plan carries no scheduled graph")

    colored = any(rec.color >= 0 for rec in facts.slots)
    if not colored:
        reason = "uncolored slot-synchronous schedule"
        for name in ("schedule/half-duplex", "schedule/color-discipline",
                     "schedule/proper-coloring"):
            cert.skipped[name] = reason
    elif facts.colors is None:
        check_half_duplex(facts)
        ran("schedule/half-duplex")
        reason = "no color assignment attached to the plan"
        cert.skipped["schedule/color-discipline"] = reason
        cert.skipped["schedule/proper-coloring"] = reason
    else:
        check_half_duplex(facts)
        ran("schedule/half-duplex")
        check_color_discipline(facts)
        ran("schedule/color-discipline")
        check_proper_coloring(facts)
        ran("schedule/proper-coloring")

    check_degree_cap(facts)
    ran("schedule/degree-cap")

    if network is not None:
        cert.max_link_flows = check_capacity(facts, network)
        ran("capacity/admissible")
    else:
        cert.skipped["capacity/admissible"] = (
            "no compiled underlay (counting-only path)")

    try:
        cert.completion_slot, cert.segment_completion = check_progress(facts)
    except _Skip as skip:
        cert.skipped["progress/causal-possession"] = str(skip)
        cert.skipped["progress/completeness"] = str(skip)
    else:
        ran("progress/causal-possession")
        ran("progress/completeness")

    check_admission_schedule(rounds, max_staleness)
    ran("staleness/window-negative")
    ran("staleness/admission-acyclic")

    if payload_mb is not None:
        cert.wire_mb = check_conservation(
            facts, payload_mb, codec, plan=plan,
            expected_stats=expected_stats)
        ran("conservation/bytes-on-wire")
    else:
        cert.skipped["conservation/bytes-on-wire"] = (
            "no payload size declared")
    return cert


def verify_policy(policy, *, network=None, payload_mb: Optional[float] = None,
                  codec=None, rounds: int = 1, max_staleness: int = 0,
                  expected_stats: Optional[Dict[str, float]] = None
                  ) -> Certificate:
    """Freeze a live :class:`~repro_torch.core.plan.CommPolicy` (one emit/commit
    walk; the policy is reset before and after) and verify it."""
    facts = PlanFacts.from_policy(policy)
    return verify_facts(facts, network=network, payload_mb=payload_mb,
                        codec=codec, rounds=rounds,
                        max_staleness=max_staleness,
                        expected_stats=expected_stats)


def verify_plan(plan, *, graph=None, network=None,
                payload_mb: Optional[float] = None, codec=None,
                rounds: int = 1, max_staleness: int = 0) -> Certificate:
    """Verify a compiled :class:`~repro_torch.core.plan.SlotPlan`. ``graph``
    restores the edge universe a compiled plan no longer carries."""
    facts = PlanFacts.from_plan(plan, graph=graph)
    return verify_facts(facts, network=network, payload_mb=payload_mb,
                        codec=codec, rounds=rounds,
                        max_staleness=max_staleness, plan=plan)


def _verified_key(spec, members: Tuple[int, ...]) -> Tuple[Any, ...]:
    from ..core.network import underlay_fingerprint
    from ..scenario.cache import policy_key

    return (policy_key(spec, members), str(spec.payload), spec.codec,
            underlay_fingerprint(spec.testbed(), spec.n), spec.rounds,
            spec.max_staleness)


def _epoch_certificate(spec, members: Tuple[int, ...], mod, overlay,
                       cache) -> Certificate:
    """Build + verify one membership epoch's plan, through the same cache
    stages the executors use (so verification *warms* the cache: the
    executor that runs next gets policy/measure hits, not rebuilds)."""
    from ..core.network import as_compiled_network
    from ..core.sparse import CSRGraph
    from ..scenario.executors import _member_testbed

    sparse = isinstance(overlay, CSRGraph)
    if sparse:
        policy = cache.sparse_policy(spec, members, overlay)
    else:
        policy = cache.policy(spec, members, lambda: mod.build_graph()[0])
    network = None
    if not sparse:
        try:
            network = as_compiled_network(_member_testbed(spec, members))
        except TypeError:
            network = None  # non-compilable underlay: capacity check skipped
    stats = cache.measure(spec, members, pol=policy)
    return verify_policy(
        policy, network=network, payload_mb=spec.payload_mb(),
        codec=spec.codec_obj(), rounds=spec.rounds,
        max_staleness=spec.max_staleness, expected_stats=stats)


def verify_scenario_plans(spec, plan_cache=None,
                          mode: str = "strict") -> Dict[str, Any]:
    """Statically verify every membership epoch a scenario will schedule.

    Walks the same moderator lifecycle the executors drive
    (:func:`~repro_torch.scenario.executors.membership_rounds`), builds each
    unique epoch's policy through the shared plan cache, and verifies it
    once — the cache's ``verified`` stage memoizes certificates by (plan
    identity, payload, codec, underlay, rounds, staleness), so re-running
    a scenario (or a sweep sharing plans across cells) never re-verifies.

    ``mode="strict"`` raises :class:`VerificationError`; ``mode="warn"``
    downgrades it to a :class:`VerificationWarning` and reports
    ``ok=False``. Returns a summary dict with per-epoch certificates.
    """
    if mode not in ("warn", "strict"):
        raise ValueError(f"verify mode must be 'warn' or 'strict', "
                         f"got {mode!r}")
    from .. import obs
    from ..scenario.cache import PlanCache
    from ..scenario.executors import membership_rounds

    spec.validate()
    cache = plan_cache if plan_cache is not None else PlanCache()
    rec = obs.get()
    overlay = cache.overlay(spec)
    certs: List[Certificate] = []
    epochs = 0
    seen: set = set()
    error: Optional[VerificationError] = None
    try:
        for r, mod, members, _applied in membership_rounds(spec, overlay):
            mt = tuple(members)
            if mt in seen:
                continue
            seen.add(mt)
            epochs += 1
            key = _verified_key(spec, mt)

            def build(mt=mt, mod=mod) -> Certificate:
                if rec.enabled:
                    with rec.span(f"verify {spec.name}", cat="verify",
                                  track="verify", scenario=spec.name,
                                  members=len(mt)):
                        cert = _epoch_certificate(spec, mt, mod, overlay,
                                                  cache)
                    rec.count("verify.plans", 1)
                    rec.count("verify.invariants", len(cert.invariants))
                else:
                    cert = _epoch_certificate(spec, mt, mod, overlay, cache)
                return cert

            certs.append(cache.verified(key, build))
    except VerificationError as exc:
        if mode == "strict":
            raise
        error = exc
        warnings.warn(
            f"scenario {spec.name!r} failed static verification: {exc}",
            VerificationWarning, stacklevel=2)
    return {
        "scenario": spec.name,
        "mode": mode,
        "ok": error is None,
        "error": None if error is None else str(error),
        "invariant": None if error is None else error.invariant,
        "epochs": epochs,
        "certificates": certs,
    }


def verify_result(spec, result, plan_cache=None) -> int:
    """Recheck an executed scenario's per-round byte accounting against the
    static wire model (the conservation invariant, applied to what an
    executor *reported* rather than what the plan schedules). Returns the
    number of rounds checked; raises :class:`VerificationError` on any
    disagreement."""
    from ..core.sparse import CSRGraph
    from ..scenario.cache import PlanCache
    from ..scenario.executors import membership_rounds

    cache = plan_cache if plan_cache is not None else PlanCache()
    overlay = cache.overlay(spec)
    payload_mb = spec.payload_mb()
    codec = spec.codec_obj()
    by_round = {rep.round: rep for rep in result.rounds}
    facts_by_epoch: Dict[Tuple[int, ...], PlanFacts] = {}
    checked = 0
    for r, mod, members, _applied in membership_rounds(spec, overlay):
        mt = tuple(members)
        facts = facts_by_epoch.get(mt)
        if facts is None:
            if isinstance(overlay, CSRGraph):
                policy = cache.sparse_policy(spec, mt, overlay)
            else:
                policy = cache.policy(spec, mt,
                                      lambda: mod.build_graph()[0])
            facts = facts_by_epoch[mt] = PlanFacts.from_policy(policy)
        rep = by_round.get(r)
        if rep is None:
            continue
        check_report_conservation(facts, payload_mb, codec, rep)
        checked += 1
    return checked
