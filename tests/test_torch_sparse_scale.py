"""The sparse planner at scale, the port against the JAX package, on the CPU.

* ``scale_100k`` (100k-node k-NN, three leaves in round 1, repaired by the
  incremental replanner) and ``scale_1m`` (a million-node ring) on the
  ``plan`` executor with one shared plan cache: every round's report and
  the cache's counters equal the reference's.
* The reference test's ``scale_100k`` shape at n = 300 (k-NN k = 8, nodes 7
  and 42 leaving in round 1), which ``chip_smoke.py``'s ``plans`` phase
  drives through the queue engine on the card: the port's engine executor
  on the CPU gives the reference's counts and bytes (3 slots / 598
  transfers, then 3 / 594 on 298 members), and the plan executor's
  ``replan_incremental`` is 1.
"""
import pytest

pytest.importorskip("torch")

from repro.core.graph import TopologySpec as JaxTopologySpec  # noqa: E402
from repro.scenario import ChurnEvent as JaxChurnEvent  # noqa: E402
from repro.scenario import ScenarioSpec as JaxScenarioSpec  # noqa: E402
from repro.scenario import run_scenario as jax_run_scenario  # noqa: E402
from repro.scenario import scenarios as jax_scenarios  # noqa: E402
from repro.scenario.cache import PlanCache as JaxPlanCache  # noqa: E402
from repro_torch.core.graph import TopologySpec  # noqa: E402
from repro_torch.scenario import ChurnEvent, ScenarioSpec, executors, scenarios  # noqa: E402
from repro_torch.scenario.cache import PlanCache  # noqa: E402
from repro_torch.scenario.executors import EngineExecutor  # noqa: E402


def test_scale_100k_and_1m_match_the_reference_plan_executor():
    cache, ref_cache = PlanCache(), JaxPlanCache()
    for name in ("scale_100k", "scale_1m"):
        got = executors.get("plan").execute(scenarios.get(name), plan_cache=cache)
        want = jax_run_scenario(jax_scenarios.get(name), executor="plan",
                                plan_cache=ref_cache)
        assert [r.to_dict() for r in got.rounds] == [r.to_dict() for r in want.rounds]
        assert got.to_dict() == want.to_dict()
        assert cache.counters == ref_cache.counters, name
    assert cache.stats() == ref_cache.stats()
    assert cache.counters["replan_incremental"] == 1 and cache.counters["replan_full"] == 2
    rounds = [(r.n_slots, r.transmissions, len(r.members)) for r in got.rounds]
    assert rounds == [(4, 1_999_998, 1_000_000)]


def _n300(torch_side=True):
    """The reference test's ``scale_100k`` shape at n = 300
    (``tests/test_sparse.py::TestPlanCacheStage::test_scale_shape_smoke``)."""
    topo, spec, churn = ((TopologySpec, ScenarioSpec, ChurnEvent) if torch_side else
                         (JaxTopologySpec, JaxScenarioSpec, JaxChurnEvent))
    return spec(name="scale_smoke", overlay=topo(kind="knn", n=300, seed=1, k=8, n_subnets=3),
                protocol="mosgu_exchange", mst_algorithm="boruvka",
                coloring_algorithm="jones_plassmann", payload=21.2, rounds=2,
                churn=(churn(1, "leave", 7), churn(1, "leave", 42)), executors=("plan",))


@pytest.mark.parametrize("codec", ("fp32", "int8"))
def test_the_n300_sparse_shape_on_the_engine_matches_the_reference(codec):
    spec, ref_spec = _n300().replace(codec=codec), _n300(False).replace(codec=codec)
    cache, ref_cache = PlanCache(), JaxPlanCache()
    got = EngineExecutor(device="cpu").execute(spec, plan_cache=cache)
    want = jax_run_scenario(ref_spec, executor="engine", plan_cache=ref_cache)
    assert got.to_dict() == want.to_dict()
    assert cache.counters == ref_cache.counters
    assert [(r.n_slots, r.transmissions, len(r.members)) for r in got.rounds] == \
        [(3, 598, 300), (3, 594, 298)]
    assert cache.counters["replan_incremental"] == 1
    plan = executors.get("plan").execute(spec, plan_cache=PlanCache())
    assert [r.to_dict() for r in plan.rounds] == [r.to_dict() for r in got.rounds]
