"""The port's copy of ``repro.opt.search.OptimizerSpec``: data only.

A scenario may declare an overlay optimizer (``ScenarioSpec.optimizer``),
and a sweep may vary it as an axis (``optimized_vs_mst``). The port keeps
the declaration so such cells expand, validate and serialize as the
reference's do; the annealed search that turns it into a working overlay
(``repro.opt``) is not ported, so nothing here plans over it.
"""
from __future__ import annotations

from dataclasses import dataclass

# the reference's objective names (``repro.opt.objective.OBJECTIVES``)
OBJECTIVE_NAMES = ("round_time", "total_bytes", "throughput", "blend", "tree_cost")
STRATEGIES = ("hillclimb", "anneal", "multistart")


@dataclass(frozen=True)
class OptimizerSpec:
    """One seeded, deterministic overlay optimization declaration."""

    objective: str = "round_time"
    strategy: str = "hillclimb"  # hillclimb | anneal | multistart
    steps: int = 160
    seed: int = 0
    restarts: int = 1  # multistart only
    init_temp: float = 0.0  # anneal: starting temperature (objective units)
    cooling: float = 0.97  # anneal: geometric decay per step
    max_degree: int = 0  # working-overlay degree cap (0 = uncapped)
    # blend weights (objective="blend")
    w_time: float = 1.0
    w_bytes: float = 0.0
    w_period: float = 0.0
    # staleness-aware throughput knobs (objective="throughput"/"blend")
    max_staleness: int = 0
    compute_time_s: float = 0.0
    # churn-aware re-optimization: BFS radius and per-churn-epoch step budget
    churn_radius: int = 2
    churn_steps: int = 40

    def validate(self) -> "OptimizerSpec":
        if self.objective not in OBJECTIVE_NAMES:
            raise ValueError(f"unknown objective {self.objective!r}; "
                             f"known: {sorted(OBJECTIVE_NAMES)}")
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
