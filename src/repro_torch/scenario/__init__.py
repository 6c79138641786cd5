"""Scenario layer of the port: the declarative spec, the registry of named
scenarios and sweeps, the sweep expansion, the counting executor and the
runner that drives a scenario's rounds on the card.

    from repro_torch.scenario import run_sweep, scenarios

    table = run_sweep(scenarios.get_sweep("codec_x_protocol"))
"""
from . import registry as scenarios
from .registry import SCENARIOS, get, register, register_sweep
from .runner import DeviceRoundReport, ScenarioRun, run_scenario
from .spec import (GOSSIP_MODES, ChurnEvent, RoundReport, ScenarioResult, ScenarioSpec,
                   resolve_gossip_mode, resolve_payload_mb)
from .sweep import SweepCell, SweepCellResult, SweepResult, SweepSpec, run_sweep

__all__ = ["GOSSIP_MODES", "SCENARIOS", "ChurnEvent", "DeviceRoundReport", "RoundReport",
           "ScenarioResult", "ScenarioRun", "ScenarioSpec", "SweepCell", "SweepCellResult",
           "SweepResult", "SweepSpec", "get", "register",
           "register_sweep", "resolve_gossip_mode", "resolve_payload_mb", "run_scenario",
           "run_sweep", "scenarios"]
