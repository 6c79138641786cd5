"""Edit-based overlay search: moves, strategies and the OptimizerSpec (the
port's copy of ``repro.opt.search``).

The search walks overlay space one *edit* at a time — add/remove/swap an
edge, rewire a node, substitute a k-NN neighbour — scoring every candidate
through the incremental :class:`~repro_torch.opt.state.SearchState` (never a full
plan rebuild) against an analytic :mod:`~repro_torch.opt.objective`. Three
strategies share the loop:

* ``hillclimb`` — greedy: commit a move only when it strictly improves;
* ``anneal`` — simulated annealing: a worsening move of Δ is accepted
  with probability ``exp(-Δ / T)`` on a geometric schedule
  ``T = init_temp * cooling^step`` (a zero ``init_temp`` degenerates to
  hill-climbing);
* ``multistart`` — ``restarts`` independent hillclimbs from the declared
  overlay, each with its own derived RNG stream; best final overlay wins.

Everything is pinned behind one seeded :class:`OptimizerSpec` — plain
frozen data, so it fingerprints for the plan cache, sweeps as a
:class:`~repro_torch.scenario.spec.ScenarioSpec` axis, and serializes through
result JSON. Determinism contract: the same (spec, overlay, context)
always produces the identical working edge set
(:meth:`OptimizeResult.fingerprint`), equal to the reference's.

Churn-aware re-optimization (:func:`reoptimize`) warm-starts from the
carried working overlay, replans the membership delta incrementally, and
restricts further moves to the BFS neighbourhood of the changed nodes.

Observability: when a recorder is active every step files an ``opt/step``
span on the ``opt/search`` track, accept/reject counters and an
``opt.objective`` sample series (visible in the Perfetto export).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np

from .. import obs
from ..core.graph import Graph
from ..core.replan import MemberPlan
from ..core.sparse import CSRGraph
from .objective import EvalContext, context_for_scenario, make_objective
from .state import Candidate, SearchState

__all__ = [
    "MOVE_KINDS",
    "STRATEGIES",
    "OptimizeResult",
    "OptimizerSpec",
    "optimize_for_scenario",
    "optimize_overlay",
    "reoptimize",
]

MOVE_KINDS = ("add_edge", "remove_edge", "swap_edge", "rewire_node",
              "knn_substitute")
STRATEGIES = ("hillclimb", "anneal", "multistart")


@dataclass(frozen=True)
class OptimizerSpec:
    """One seeded, deterministic overlay optimization declaration.

    Plain frozen data: hashable (plan-cache fingerprint component via
    ``_field_tuple``), sweepable as a ScenarioSpec axis, and serializable
    through :meth:`to_dict`/:meth:`from_dict`.
    """

    objective: str = "round_time"
    strategy: str = "hillclimb"  # hillclimb | anneal | multistart
    steps: int = 160
    seed: int = 0
    restarts: int = 1  # multistart only
    init_temp: float = 0.0  # anneal: starting temperature (objective units)
    cooling: float = 0.97  # anneal: geometric decay per step
    # working-overlay degree cap (0 = uncapped); every accepted edit
    # respects it
    max_degree: int = 0
    # blend weights (objective="blend")
    w_time: float = 1.0
    w_bytes: float = 0.0
    w_period: float = 0.0
    # staleness-aware throughput knobs (objective="throughput"/"blend")
    max_staleness: int = 0
    compute_time_s: float = 0.0
    # churn-aware re-optimization: BFS radius of the affected
    # neighbourhood and the per-churn-epoch step budget
    churn_radius: int = 2
    churn_steps: int = 40

    def validate(self) -> "OptimizerSpec":
        from .objective import OBJECTIVES

        if self.objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {self.objective!r}; "
                             f"known: {sorted(OBJECTIVES)}")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"known: {STRATEGIES}")
        if self.steps < 1:
            raise ValueError("steps must be >= 1")
        if self.restarts < 1:
            raise ValueError("restarts must be >= 1")
        if not (0.0 < self.cooling <= 1.0):
            raise ValueError("cooling must be in (0, 1]")
        if self.init_temp < 0 or self.max_degree < 0:
            raise ValueError("init_temp and max_degree must be >= 0")
        if self.churn_radius < 0 or self.churn_steps < 0:
            raise ValueError("churn_radius and churn_steps must be >= 0")
        return self

    def to_dict(self) -> dict:
        return {f: getattr(self, f) for f in self.__dataclass_fields__}

    @classmethod
    def from_dict(cls, d: dict) -> "OptimizerSpec":
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        return cls(**known).validate()


@dataclass
class OptimizeResult:
    """What one optimization produced, with its provenance."""

    overlay: Union[Graph, CSRGraph]  # same flavour as the input overlay
    plan: MemberPlan  # exact member plan of the optimized working set
    base_score: float  # objective of the declared (MST) overlay
    best_score: float  # objective of the optimized overlay
    steps: int
    accepted: int
    rejected: int
    state: SearchState = dataclasses.field(repr=False, default=None)
    spec: Optional[OptimizerSpec] = None

    @property
    def improvement(self) -> float:
        """base/best score ratio (> 1 means the optimizer won)."""
        return self.base_score / self.best_score if self.best_score else 1.0

    def fingerprint(self) -> str:
        """Deterministic identity of the optimized overlay (the
        same-spec-same-overlay contract)."""
        return self.state.fingerprint()


# ---------------------------------------------------------------------------
# Moves
# ---------------------------------------------------------------------------


def _propose(state: SearchState, rng: np.random.Generator,
             allowed: Optional[np.ndarray]
             ) -> Optional[Tuple[str, np.ndarray, np.ndarray]]:
    """One random edit proposal: (kind, remove indices, add indices).

    ``allowed`` (a node-id array) restricts moves to edges touching the
    set — the churn re-optimization neighbourhood. Returns ``None`` when
    the drawn kind has no legal instance (e.g. nothing inactive to add).
    """
    live = state.live_member_edges()
    mmask = np.zeros(state.n, dtype=bool)
    mmask[state.members] = True
    inactive = np.flatnonzero(~state.active
                              & mmask[state.eu] & mmask[state.ev])
    if allowed is not None:
        amask = np.zeros(state.n, dtype=bool)
        amask[allowed] = True
        live = live[amask[state.eu[live]] | amask[state.ev[live]]]
        inactive = inactive[amask[state.eu[inactive]]
                            | amask[state.ev[inactive]]]
    empty = np.empty(0, dtype=np.int64)
    kind = MOVE_KINDS[int(rng.integers(len(MOVE_KINDS)))]
    if kind == "add_edge":
        if not len(inactive):
            return None
        return kind, empty, inactive[[int(rng.integers(len(inactive)))]]
    if kind == "remove_edge":
        if not len(live):
            return None
        return kind, live[[int(rng.integers(len(live)))]], empty
    if kind == "swap_edge":
        if not len(live) or not len(inactive):
            return None
        return (kind, live[[int(rng.integers(len(live)))]],
                inactive[[int(rng.integers(len(inactive)))]])
    # node-centric kinds: pick a member with both a live and an inactive
    # incident edge
    pool = state.members if allowed is None else np.intersect1d(
        state.members, allowed)
    if not len(pool):
        return None
    v = int(pool[int(rng.integers(len(pool)))])
    inc = state.incident_edges(v)
    other = np.where(state.eu[inc] == v, state.ev[inc], state.eu[inc])
    ok = mmask[other]
    inc, other = inc[ok], other[ok]
    inc_live = inc[state.active[inc]]
    inc_off = inc[~state.active[inc]]
    if not len(inc_live) or not len(inc_off):
        return None
    if kind == "rewire_node":
        return (kind, inc_live[[int(rng.integers(len(inc_live)))]],
                inc_off[[int(rng.integers(len(inc_off)))]])
    # knn_substitute: drop v's costliest working neighbour for its cheapest
    # unused universe neighbour (edge indices ARE the (w, u, v) order)
    return (kind, np.array([inc_live.max()], dtype=np.int64),
            np.array([inc_off.min()], dtype=np.int64))


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------


def _descend(state: SearchState, objective, ctx: EvalContext,
             spec: OptimizerSpec, rng: np.random.Generator,
             steps: int, allowed: Optional[np.ndarray] = None
             ) -> Tuple[float, int, int]:
    """The shared accept/reject loop (hillclimb when init_temp == 0)."""
    rec = obs.get()
    cur = objective(_as_candidate(state), ctx)
    best_score = cur
    best_snap = state.snapshot()
    accepted = rejected = 0
    temp = spec.init_temp
    for step in range(steps):
        move = _propose(state, rng, allowed)
        take = False
        if move is not None:
            kind, rem, add = move
            if rec.enabled:
                with rec.span("opt/step", cat="opt", track="opt/search",
                              step=step, kind=kind):
                    cand = state.try_edit(rem, add)
                    score = (objective(cand, ctx) if cand is not None
                             else float("inf"))
            else:
                cand = state.try_edit(rem, add)
                score = (objective(cand, ctx) if cand is not None
                         else float("inf"))
            if cand is not None:
                delta = score - cur
                take = delta < -1e-12 or (
                    temp > 0.0 and float(rng.random())
                    < math.exp(-max(delta, 0.0) / temp))
            if take:
                state.commit(cand)
                cur = score
                accepted += 1
                if cur < best_score:
                    best_score = cur
                    best_snap = state.snapshot()
            else:
                rejected += 1
        else:
            rejected += 1
        if rec.enabled:
            rec.count("opt.accepted" if take else "opt.rejected")
            rec.sample("opt.objective", rec.now(), cur,
                       track="opt/objective")
        temp *= spec.cooling
    if cur > best_score:  # annealing can end off its best-seen point
        state.restore(best_snap)
        cur = best_score
    return cur, accepted, rejected


def _as_candidate(state: SearchState) -> Candidate:
    """The current state viewed as a (no-op) candidate, for scoring."""
    empty = np.empty(0, dtype=np.int64)
    return Candidate(state, state.plan(), state.tree_idx, empty, empty)


def _as_csr(overlay: Union[Graph, CSRGraph]) -> CSRGraph:
    if isinstance(overlay, CSRGraph):
        return overlay
    return CSRGraph.from_dense(overlay)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def optimize_overlay(overlay: Union[Graph, CSRGraph], ctx: EvalContext,
                     spec: OptimizerSpec,
                     members: Optional[Sequence[int]] = None
                     ) -> OptimizeResult:
    """Search edge subsets of ``overlay`` for the best objective score.

    The declared overlay is the edge *universe*: the optimizer only ever
    toggles existing (cost-reported) edges, so every working overlay is a
    subgraph whose costs the moderator actually measured. The result's
    ``overlay`` is the working edge set in the input's flavour (dense
    :class:`Graph` in, dense out), ready to be used as an explicit
    cost-matrix :class:`~repro_torch.scenario.spec.ScenarioSpec` overlay.
    """
    spec.validate()
    objective = make_objective(spec.objective)
    dense_in = not isinstance(overlay, CSRGraph)
    universe = _as_csr(overlay)
    max_deg = spec.max_degree
    restarts = spec.restarts if spec.strategy == "multistart" else 1
    rec = obs.get()

    best: Optional[Tuple[float, SearchState, int, int]] = None
    base_score: Optional[float] = None
    total_steps = 0
    for r in range(restarts):
        state = SearchState(universe, members=members, seed=spec.seed,
                            max_degree=max_deg)
        rng = np.random.default_rng([spec.seed, r])
        if base_score is None:
            base_score = objective(_as_candidate(state), ctx)
        if rec.enabled:
            with rec.span("opt/restart", cat="opt", track="opt/search",
                          restart=r):
                final, acc, rej = _descend(state, objective, ctx, spec,
                                           rng, spec.steps)
        else:
            final, acc, rej = _descend(state, objective, ctx, spec, rng,
                                       spec.steps)
        total_steps += spec.steps
        if best is None or final < best[0]:
            best = (final, state, acc, rej)
    final, state, acc, rej = best
    out = state.working_graph() if dense_in else state.working_csr()
    if rec.enabled:
        rec.gauge("opt.base_score", base_score)
        rec.gauge("opt.best_score", final)
    return OptimizeResult(overlay=out, plan=state.plan(),
                          base_score=base_score, best_score=final,
                          steps=total_steps, accepted=acc, rejected=rej,
                          state=state, spec=spec)


def reoptimize(result: OptimizeResult, ctx: EvalContext,
               members: Sequence[int]) -> OptimizeResult:
    """Churn-aware re-optimization: warm-start from the carried overlay.

    The working edge set survives; the membership delta is repaired
    incrementally (:meth:`SearchState.set_members`, which routes through
    :meth:`~repro_torch.core.replan.SparsePlanner.replan`) and further edit moves
    are restricted to the ``churn_radius``-hop neighbourhood of the changed
    nodes — the whole overlay is *not* re-searched.
    """
    spec = result.spec or OptimizerSpec()
    state = result.state
    old = set(int(m) for m in state.members)
    new = set(int(m) for m in members)
    changed = sorted(old.symmetric_difference(new))
    state.set_members(members)
    objective = make_objective(spec.objective)
    base = objective(_as_candidate(state), ctx)
    allowed = state.affected_nodes(changed, radius=spec.churn_radius)
    rng = np.random.default_rng([spec.seed, len(changed), len(new)])
    final, acc, rej = _descend(state, objective, ctx, spec, rng,
                               spec.churn_steps, allowed=allowed)
    dense_out = isinstance(result.overlay, Graph)
    out = state.working_graph() if dense_out else state.working_csr()
    return OptimizeResult(overlay=out, plan=state.plan(), base_score=base,
                          best_score=final, steps=spec.churn_steps,
                          accepted=acc, rejected=rej, state=state,
                          spec=spec)


def optimize_for_scenario(spec, base_overlay: Optional[
        Union[Graph, CSRGraph]] = None) -> OptimizeResult:
    """Optimize a scenario's declared overlay against its own context.

    ``spec`` is duck-typed on the ScenarioSpec surface (no scenario import
    here); this is what :meth:`repro_torch.scenario.cache.PlanCache.overlay`
    calls on the ``opt`` stage when ``spec.optimizer`` is set.
    """
    if spec.optimizer is None:
        raise ValueError("scenario declares no optimizer")
    overlay = base_overlay if base_overlay is not None \
        else spec.overlay_graph()
    ctx = context_for_scenario(spec)
    return optimize_overlay(overlay, ctx, spec.optimizer)
