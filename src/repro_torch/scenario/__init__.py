"""Scenario layer of the port: the scenarios' gossip-relevant fields and
the runner that drives their rounds on the card."""
from .runner import RoundReport, ScenarioRun, run_scenario
from .spec import GOSSIP_MODES, SCENARIOS, ChurnEvent, ScenarioSpec, get, membership_by_round

__all__ = ["GOSSIP_MODES", "SCENARIOS", "ChurnEvent", "RoundReport", "ScenarioRun",
           "ScenarioSpec", "get", "membership_by_round", "run_scenario"]
