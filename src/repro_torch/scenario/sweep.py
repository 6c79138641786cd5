"""Sweep API: one declaration expands a whole experiment grid (the port's
copy of ``repro.scenario.sweep``).

``grid`` axes expand to their cartesian product (declaration order, last
axis fastest); ``zip`` axes advance in lockstep as one trailing grid axis.
An axis may be any :class:`ScenarioSpec` field, any overlay field through
``overlay.<field>`` (aliases ``topology`` -> ``overlay.kind`` and ``n`` ->
``overlay.n``), or ``seed``, which sets both the overlay's seed and the
link-failure seed. Every cell is made with :meth:`ScenarioSpec.replace`,
which re-validates. A cell is named ``NAME/axis=value,...``, or
``axis[index]`` where the value is not a scalar.

:func:`run_sweep` runs every cell on one executor (``plan``: counts and the
analytic round times; ``engine``: the queue engine; ``netsim``: the fluid
simulator; ``event``: the asynchronous event engine), one cell after
another through one :class:`~repro_torch.scenario.cache.PlanCache` (MST,
coloring, policy, timing profile and membership trajectory once a unique
key; the ``plan`` executor batches the whole grid's counting in one numpy
pass), with results equal to serial ``execute`` calls; the cache's counters
land in ``SweepResult.cache_stats``. :meth:`SweepResult.marginals` averages
each axis value's cells.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..core.graph import TopologySpec
from .spec import ScenarioResult, ScenarioSpec

# axis aliases: friendly sweep names for overlay generator fields
AXIS_ALIASES = {"topology": "overlay.kind", "n": "overlay.n"}

_SPEC_FIELDS = {f.name for f in dataclasses.fields(ScenarioSpec)}
_OVERLAY_FIELDS = {f.name for f in dataclasses.fields(TopologySpec)}


def _resolve_axis(axis: str) -> str:
    """Canonical axis name; raises for anything a sweep cannot vary."""
    name = AXIS_ALIASES.get(axis, axis)
    if name == "seed":
        return name  # threads into overlay.seed AND drop_seed
    if name.startswith("overlay."):
        f = name.split(".", 1)[1]
        if f not in _OVERLAY_FIELDS:
            raise ValueError(
                f"unknown overlay axis {axis!r}; overlay fields: "
                f"{sorted(_OVERLAY_FIELDS)}")
        return name
    if name not in _SPEC_FIELDS:
        raise ValueError(
            f"unknown sweep axis {axis!r}; expected a ScenarioSpec field "
            f"({sorted(_SPEC_FIELDS)}), 'overlay.<field>', 'seed', or an "
            f"alias ({sorted(AXIS_ALIASES)})")
    return name


@dataclass(frozen=True)
class SweepCell:
    """One expanded grid point: its coordinates and the concrete spec."""

    index: int
    coords: Dict[str, Any]
    spec: ScenarioSpec


@dataclass
class SweepSpec:
    """A declarative experiment grid over one base :class:`ScenarioSpec`."""

    name: str = "sweep"
    base: ScenarioSpec = field(default_factory=ScenarioSpec)
    grid: Mapping[str, Sequence[Any]] = field(default_factory=dict)
    zip: Mapping[str, Sequence[Any]] = field(default_factory=dict)
    description: str = ""

    def validate(self) -> "SweepSpec":
        seen = set()
        for axis in list(self.grid) + list(self.zip):
            canon = _resolve_axis(axis)
            # "seed" fans out to two fields; both count as declared
            targets = {"overlay.seed", "drop_seed"} if canon == "seed" else {canon}
            if targets & seen:
                raise ValueError(f"axis {axis!r} declared twice")
            seen |= targets
        for axis, values in list(self.grid.items()) + list(self.zip.items()):
            if len(tuple(values)) == 0:
                raise ValueError(f"axis {axis!r} has no values")
        zip_lens = {k: len(tuple(v)) for k, v in self.zip.items()}
        if len(set(zip_lens.values())) > 1:
            raise ValueError(f"zip axes must have equal lengths, got {zip_lens}")
        return self

    def axes(self) -> Dict[str, List[Any]]:
        """All axes (grid first, then zip) with their declared values."""
        out: Dict[str, List[Any]] = {k: list(v) for k, v in self.grid.items()}
        out.update({k: list(v) for k, v in self.zip.items()})
        return out

    @property
    def n_cells(self) -> int:
        n = 1
        for values in self.grid.values():
            n *= len(tuple(values))
        if self.zip:
            n *= len(tuple(next(iter(self.zip.values()))))
        return n

    def cells(self) -> List[SweepCell]:
        """Cartesian product of the grid axes in declaration order (last axis
        fastest), the zip axes in lockstep as one trailing axis; each cell
        re-validates."""
        self.validate()
        grid_names = list(self.grid)
        grid_values = [tuple(self.grid[k]) for k in grid_names]
        zip_names = list(self.zip)
        zip_rows: List[Tuple[Any, ...]] = (
            list(zip(*(tuple(self.zip[k]) for k in zip_names))) if zip_names else [()])
        out: List[SweepCell] = []
        for combo in itertools.product(*grid_values) if grid_names else [()]:
            for row in zip_rows:
                coords = dict(zip(grid_names, combo))
                coords.update(dict(zip(zip_names, row)))
                index = len(out)
                out.append(SweepCell(index=index, coords=coords,
                                     spec=self._materialize(index, coords)))
        return out

    def _materialize(self, index: int, coords: Dict[str, Any]) -> ScenarioSpec:
        """One cell's spec: every axis value applied in one validated
        ``replace``."""
        spec_changes: Dict[str, Any] = {}
        overlay_changes: Dict[str, Any] = {}
        for axis, value in coords.items():
            canon = _resolve_axis(axis)
            if canon == "seed":
                overlay_changes["seed"] = value
                spec_changes["drop_seed"] = value
            elif canon.startswith("overlay."):
                overlay_changes[canon.split(".", 1)[1]] = value
            else:
                spec_changes[canon] = value
        if overlay_changes:
            spec_changes["overlay"] = dataclasses.replace(self.base.overlay, **overlay_changes)
        tokens = [f"{axis}={value}" if np.isscalar(value) else f"{axis}[{index}]"
                  for axis, value in coords.items()]
        spec_changes["name"] = f"{self.name}/{','.join(tokens)}" if tokens else self.name
        return self.base.replace(**spec_changes)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "description": self.description,
            "base": self.base.to_dict(),
            "grid": {k: [_jsonable(v) for v in vals] for k, vals in self.grid.items()},
            "zip": {k: [_jsonable(v) for v in vals] for k, vals in self.zip.items()},
            "n_cells": self.n_cells,
        }


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "to_dict"):
        return v.to_dict()
    return str(v)


@dataclass
class SweepCellResult:
    """One cell's outcome, carrying its grid coordinates."""

    index: int
    coords: Dict[str, Any]
    spec: ScenarioSpec
    result: ScenarioResult

    def row(self) -> Dict[str, Any]:
        """The flat table row: coordinates + the cell's aggregate totals."""
        totals = self.result.to_dict()["totals"]
        return {"cell": self.index,
                **{k: _jsonable(v) for k, v in self.coords.items()},
                "scenario": self.result.scenario,
                "protocol": self.result.protocol,
                "payload_mb": self.result.payload_mb,
                **totals}


@dataclass
class SweepResult:
    """The whole grid's outcome: a flat cell table, JSON-serializable."""

    sweep: str
    executor: str
    axes: Dict[str, List[Any]]
    cells: List[SweepCellResult]
    cache_stats: Dict[str, int] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.cells)

    def __getitem__(self, index: int) -> SweepCellResult:
        return self.cells[index]

    def table(self) -> List[Dict[str, Any]]:
        return [c.row() for c in self.cells]

    def marginals(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        """Per-axis aggregates: for each axis value, metrics averaged (and
        summed) over every cell holding that value."""
        out: Dict[str, Dict[str, Dict[str, Any]]] = {}
        for axis, values in self.axes.items():
            rows: Dict[str, Dict[str, Any]] = {}
            for value in values:
                sel = [c.result for c in self.cells
                       if axis in c.coords and c.coords[axis] == value]
                if not sel:
                    continue
                times = [r.total_time_s for r in sel if r.total_time_s is not None]
                rows[str(_jsonable(value))] = {
                    "cells": len(sel),
                    "total_transmissions": int(sum(r.total_transmissions for r in sel)),
                    "mean_transmissions": float(np.mean([r.total_transmissions for r in sel])),
                    "mean_bytes_mb": float(np.mean([r.total_bytes_mb for r in sel])),
                    "mean_bytes_on_wire_mb": float(np.mean(
                        [r.total_bytes_on_wire_mb for r in sel])),
                    "mean_time_s": float(np.mean(times)) if times else None,
                }
            out[axis] = rows
        return out

    def reports(self) -> Optional[List[Dict[str, Any]]]:
        """Per-cell RunReports (``{"cell": i, **report}``), or ``None`` when
        the grid ran without an active recorder."""
        if all(c.result.report is None for c in self.cells):
            return None
        return [{"cell": c.index, **(c.result.report or {})} for c in self.cells]

    def to_dict(self) -> Dict[str, Any]:
        reports = self.reports()
        return {
            "sweep": self.sweep,
            "executor": self.executor,
            "axes": {k: [_jsonable(v) for v in vals] for k, vals in self.axes.items()},
            "n_cells": len(self.cells),
            "cells": self.table(),
            "marginals": self.marginals(),
            "cache": self.cache_stats,
            **({"reports": reports} if reports is not None else {}),
        }


def run_sweep(sweep: SweepSpec, executor: Any = "plan", plan_cache: Optional[Any] = None,
              record_trace: bool = False) -> SweepResult:
    """Run every cell of a sweep on one executor through one plan cache: a
    name (``plan``, ``engine``, ``netsim``, ``event``) or an
    :class:`~repro_torch.scenario.executors.Executor` instance (e.g.
    ``EngineExecutor(device="cpu")``), which runs every cell
    (:meth:`~repro_torch.scenario.executors.Executor.run_cells`). Each
    cell's result is what a serial ``execute(cell.spec)`` returns."""
    from .cache import PlanCache
    from .executors import get as get_executor

    ex = get_executor(executor)
    cells = sweep.cells()
    cache = plan_cache if plan_cache is not None else PlanCache()
    results = ex.run_cells(cells, plan_cache=cache, record_trace=record_trace)
    return SweepResult(
        sweep=sweep.name, executor=ex.name, axes=sweep.axes(),
        cells=[SweepCellResult(index=c.index, coords=c.coords, spec=c.spec, result=r)
               for c, r in zip(cells, results)],
        cache_stats=cache.stats())
