"""Scenario layer of the port: the declarative spec, the registry of named
scenarios and sweeps, the sweep expansion, the cross-cell plan cache
(:class:`PlanCache`), the executors (``plan``: counts and analytic round
times; ``engine``: the FIFO queue engine with drops and encoded payloads;
``netsim``: the fluid simulator; ``device``: the gossip collectives on the
card, the reference's ``jax``; ``event``: the asynchronous event engine)
and the front door :func:`run_scenario`.

    from repro_torch.scenario import DeviceExecutor, run_scenario, run_sweep, scenarios

    res = run_scenario(scenarios.get("paper_table3"), executor="netsim")
    table = run_sweep(scenarios.get_sweep("wan_sweep"), executor="plan")
    print(table.marginals()["underlay"])
    cells = run_sweep(scenarios.get_sweep("codec_x_protocol"),
                      executor=DeviceExecutor(seed=1))  # on the card
"""
from . import executors
from . import registry as scenarios
from .cache import PlanCache
from .executors import DeviceExecutor, DeviceRoundReport, Executor, RoundContext, ScenarioRun
from .registry import SCENARIOS, get, register, register_sweep
from .runner import compare_protocols, run_scenario
from .spec import (GOSSIP_MODES, ChurnEvent, RoundReport, ScenarioResult, ScenarioSpec,
                   resolve_gossip_mode, resolve_payload_mb)
from .sweep import SweepCell, SweepCellResult, SweepResult, SweepSpec, run_sweep

__all__ = ["GOSSIP_MODES", "SCENARIOS", "ChurnEvent", "DeviceExecutor", "DeviceRoundReport",
           "Executor", "PlanCache", "RoundContext", "RoundReport", "ScenarioResult",
           "ScenarioRun", "ScenarioSpec", "SweepCell", "SweepCellResult", "SweepResult",
           "SweepSpec", "compare_protocols", "executors", "get", "register", "register_sweep",
           "resolve_gossip_mode", "resolve_payload_mb", "run_scenario", "run_sweep", "scenarios"]
