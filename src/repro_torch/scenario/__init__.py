"""Scenario layer of the port: the declarative spec, the registry of named
scenarios and sweeps, the sweep expansion, the cross-cell plan cache
(:class:`PlanCache`), the host executors (``plan``: counts and analytic
round times; ``engine``: the FIFO queue engine with
drops and encoded payloads; ``netsim``: the fluid simulator; ``event``: the
asynchronous event engine) and the runner that drives a scenario's rounds
on the card.

    from repro_torch.scenario import executors, run_sweep, scenarios

    res = executors.get("netsim").execute(scenarios.get("paper_table3"))
    table = run_sweep(scenarios.get_sweep("wan_sweep"), executor="plan")
    print(table.marginals()["underlay"])
"""
from . import executors
from . import registry as scenarios
from .cache import PlanCache
from .executors import Executor, RoundContext
from .registry import SCENARIOS, get, register, register_sweep
from .runner import DeviceRoundReport, ScenarioRun, compare_protocols, run_scenario
from .spec import (GOSSIP_MODES, ChurnEvent, RoundReport, ScenarioResult, ScenarioSpec,
                   resolve_gossip_mode, resolve_payload_mb)
from .sweep import SweepCell, SweepCellResult, SweepResult, SweepSpec, run_sweep

__all__ = ["GOSSIP_MODES", "SCENARIOS", "ChurnEvent", "DeviceRoundReport", "Executor",
           "PlanCache", "RoundContext", "RoundReport",
           "ScenarioResult", "ScenarioRun", "ScenarioSpec", "SweepCell", "SweepCellResult",
           "SweepResult", "SweepSpec", "compare_protocols", "executors", "get", "register",
           "register_sweep", "resolve_gossip_mode", "resolve_payload_mb", "run_scenario",
           "run_sweep", "scenarios"]
