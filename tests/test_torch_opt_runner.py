"""The card executor over the plan cache's effective overlay, on the CPU.

For every ``optimized_vs_mst`` cell, ``run_scenario(spec,
executor=DeviceExecutor(device="cpu", proxy_elems=4))`` plans the device
round over the overlay the plan cache builds: the annealed working subgraph for an optimizer cell. Its device
plan has the MST, colors and permutation steps of the reference jax
executor's ``_plan_for_members(..., full_graph=PlanCache().overlay(spec))``,
its counts are the reference plan executor's, and ``numerics_ok`` holds.
The card's case of the same check is ``tests/test_torch_gpu.py``'s (it
skips without CUDA).
"""
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.dfl.session import _plan_for_members  # noqa: E402
from repro.scenario import run_scenario as jax_run_scenario  # noqa: E402
from repro.scenario import scenarios as jax_scenarios  # noqa: E402
from repro.scenario.cache import PlanCache as JaxPlanCache  # noqa: E402
from repro_torch.dfl.session import plan_for_members  # noqa: E402
from repro_torch.scenario import DeviceExecutor, executors, run_scenario, scenarios  # noqa: E402
from repro_torch.scenario.cache import PlanCache  # noqa: E402

CELLS = range(4)


def _steps_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.perm == b.perm
        np.testing.assert_array_equal(a.send_payload, b.send_payload)
        np.testing.assert_array_equal(a.recv_payload, b.recv_payload)


def _reference_plan(i):
    spec = jax_scenarios.get_sweep("optimized_vs_mst").cells()[i].spec
    overlay = JaxPlanCache().overlay(spec)
    mesh = types.SimpleNamespace(shape={"data": spec.n})
    return _plan_for_members(mesh, ("data",), set(range(spec.n)),
                             n_segments=spec.n_segments, full_graph=overlay), spec


def _check(i):
    spec = scenarios.get_sweep("optimized_vs_mst").cells()[i].spec
    cache = PlanCache()
    ex = DeviceExecutor(device="cpu", proxy_elems=4)
    ours = run_scenario(spec, executor=ex, plan_cache=cache)
    run = ex.run
    want, ref_spec = _reference_plan(i)
    (plan,) = run.plans
    np.testing.assert_array_equal(plan.mst.adj, want.mst.adj)
    np.testing.assert_array_equal(plan.colors, want.colors)
    _steps_equal(plan.diss_steps, want.diss_steps)
    _steps_equal(plan.tree_steps, want.tree_steps)
    _steps_equal(plan.seg_steps, want.seg_steps)
    assert plan.dissemination.total_transmissions() == want.dissemination.total_transmissions()
    counted = jax_run_scenario(ref_spec, executor="plan")
    for got, r in zip(run.rounds, counted.rounds):
        assert (got.n_slots, got.transmissions, got.bytes_mb, got.bytes_on_wire_mb) == \
            (r.n_slots, r.transmissions, r.bytes_mb, r.bytes_on_wire_mb)
        assert got.numerics_ok is True and got.finite
    # an optimizer cell is searched once: the card run's overlay, which the
    # plan executor's run on the same cache takes from the cache's opt stage;
    # its plan is not the one over the declared overlay
    if spec.optimizer is not None:
        assert cache.counters["opt_misses"] == 1 and cache.counters["opt_hits"] == 0
        again = executors.get("plan").execute(spec, plan_cache=cache)
        assert cache.counters["opt_misses"] == 1 and cache.counters["opt_hits"] == 1
        counts = [(r.members, r.n_slots, r.transmissions, r.bytes_mb, r.bytes_on_wire_mb)
                  for res in (ours, again) for r in res.rounds]
        assert counts[:len(ours.rounds)] == counts[len(ours.rounds):]
        declared = plan_for_members(spec.n, range(spec.n), n_segments=spec.n_segments,
                                    full_graph=spec.overlay_graph())
        assert not np.array_equal(plan.mst.adj, declared.mst.adj)


@pytest.mark.parametrize("i", CELLS)
def test_runner_plans_over_the_caches_effective_overlay(i):
    _check(i)

