"""Adaptive overlay optimization: analytic-cost-guided topology search (the
port's copy of ``repro.opt``, numpy only).

A seeded, deterministic edit-based search over overlay topologies where
every candidate is scored by the closed-form timing / throughput oracle
(:mod:`repro_torch.core.network`) through exact incremental plan
maintenance: never a full plan rebuild, never a simulator run in the inner
loop. The same spec draws the reference's random numbers in the
reference's order, so its working overlay and fingerprint equal the
reference's. The scenario plan cache's ``opt`` stage
(:meth:`repro_torch.scenario.cache.PlanCache.overlay`) calls
:func:`optimize_for_scenario` for a spec that declares an optimizer.
"""
from .membership import membership_descent
from .objective import (
    OBJECTIVES,
    EvalContext,
    Objective,
    context_for_scenario,
    make_objective,
)
from .search import (
    MOVE_KINDS,
    STRATEGIES,
    OptimizeResult,
    OptimizerSpec,
    optimize_for_scenario,
    optimize_overlay,
    reoptimize,
)
from .state import Candidate, SearchState

__all__ = [
    "MOVE_KINDS",
    "OBJECTIVES",
    "STRATEGIES",
    "Candidate",
    "EvalContext",
    "Objective",
    "OptimizeResult",
    "OptimizerSpec",
    "SearchState",
    "context_for_scenario",
    "make_objective",
    "membership_descent",
    "optimize_for_scenario",
    "optimize_overlay",
    "reoptimize",
]
