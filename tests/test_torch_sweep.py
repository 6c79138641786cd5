"""The port's sweep path against the JAX package's, on the CPU.

* Every registered sweep expands to the reference's cells: the same count,
  the same coordinates, and ``spec.to_dict()`` equal cell for cell.
* The port's scenarios serialize as the reference's registry entries, and
  a spec survives ``from_dict(to_dict())``.
* ``make_topology`` for ``barabasi_albert`` gives the reference's cost
  matrix; ``measure_policy(make_policy(p, g))`` gives the reference's
  counts for every protocol on ER, WS, BA and complete overlays.
* ``python -m repro_torch.launch.train --sweep NAME`` prints the reference
  launcher's dry table line for line (the reference in a subprocess);
  ``async_vs_sync`` raises the reference's capability error,
  ``optimized_vs_mst`` raises by name, ``table3_full --cell 0`` the
  reference's gossip-mode error, and a bad ``--cell`` exits.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.graph import TopologySpec as JaxTopologySpec  # noqa: E402
from repro.core.graph import make_topology as jax_make_topology  # noqa: E402
from repro.core.plan import PROTOCOL_NAMES as JAX_PROTOCOL_NAMES  # noqa: E402
from repro.core.plan import make_policy as jax_make_policy  # noqa: E402
from repro.core.plan import measure_policy as jax_measure_policy  # noqa: E402
from repro.scenario import run_sweep as jax_run_sweep  # noqa: E402
from repro.scenario import scenarios as jax_scenarios  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.graph import TopologySpec, make_topology  # noqa: E402
from repro_torch.core.plan import PROTOCOL_NAMES, make_policy, measure_policy  # noqa: E402
from repro_torch.launch.train import main  # noqa: E402
from repro_torch.scenario import ScenarioSpec, run_sweep, scenarios  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEPS = ("table3_full", "payload_latency_curve", "codec_x_protocol", "wan_sweep",
          "async_vs_sync", "optimized_vs_mst")
DRY_TABLES = ("table3_full", "payload_latency_curve", "codec_x_protocol", "wan_sweep")
SCENARIO_NAMES = ("paper_table3", "quantized_table3", "topk_sweep", "mesh_smoke", "churn_storm")


def _plain(v):
    return v.to_dict() if hasattr(v, "to_dict") else v


def _reference(*args, timeout=300):
    """The reference launcher in a subprocess: (returncode, stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "repro.launch.train", *args],
                          capture_output=True, text=True, env=env, timeout=timeout)
    return proc.returncode, proc.stdout, proc.stderr


def test_the_registries_name_the_same_sweeps():
    assert scenarios.sweep_names() == jax_scenarios.sweep_names() == sorted(SWEEPS)
    assert set(SCENARIO_NAMES) == set(scenarios.names()) < set(jax_scenarios.names())


@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_cells_match_the_reference(name):
    ours, theirs = scenarios.get_sweep(name), jax_scenarios.get_sweep(name)
    assert ours.to_dict() == theirs.to_dict()
    cells, want = ours.cells(), theirs.cells()
    assert len(cells) == len(want) == ours.n_cells
    for c, w in zip(cells, want):
        assert c.index == w.index
        assert {k: _plain(v) for k, v in c.coords.items()} == \
            {k: _plain(v) for k, v in w.coords.items()}
        assert c.spec.name == w.spec.name
        assert c.spec.to_dict() == w.spec.to_dict()


def test_a_non_scalar_axis_names_its_cell_by_index():
    names = [c.spec.name for c in scenarios.get_sweep("optimized_vs_mst").cells()]
    assert names[1] == "optimized_vs_mst/underlay=wan,optimizer[1]"
    assert "optimizer" not in scenarios.get_sweep("optimized_vs_mst").cells()[0].spec.to_dict()


@pytest.mark.parametrize("name", SCENARIO_NAMES)
def test_scenarios_serialize_as_the_reference(name):
    ours = scenarios.get(name)
    assert ours.to_dict() == jax_scenarios.get(name).to_dict()
    assert ScenarioSpec.from_dict(ours.to_dict()).to_dict() == ours.to_dict()


def test_arch_payload_resolves_to_the_reference_mb():
    # mesh_smoke's payload: smollm-360m's analytic count x 2 bytes
    assert scenarios.get("mesh_smoke").payload_mb() == 723.64032
    from repro.configs import get_arch as jax_get_arch

    for arch in ("smollm-360m", "whisper-tiny", "falcon-mamba-7b", "zamba2-7b",
                 "qwen3-moe-30b-a3b", "arctic-480b"):
        assert get_arch(arch).param_count() == jax_get_arch(arch).param_count(), arch


def test_replace_revalidates():
    spec = scenarios.get("paper_table3")
    with pytest.raises(ValueError, match="unknown codec 'int3'"):
        spec.replace(codec="int3")
    with pytest.raises(ValueError, match="unknown network preset"):
        spec.replace(underlay="moon")
    with pytest.raises(ValueError, match="unknown sweep axis"):
        dataclasses.replace(scenarios.get_sweep("codec_x_protocol"),
                            grid={"codecs": ("int8",)}).cells()
    with pytest.raises(ValueError, match="unknown topology kind 'knn'.*sparse kinds .* are not ported"):
        make_topology(TopologySpec(kind="knn", n=10))


@pytest.mark.parametrize("n,m,seed", [(10, 2, 3), (12, 2, 0), (16, 3, 7), (30, 1, 11)])
def test_barabasi_albert_matches_the_reference(n, m, seed):
    ours = make_topology(TopologySpec(kind="barabasi_albert", n=n, m=m, seed=seed))
    theirs = jax_make_topology(JaxTopologySpec(kind="barabasi_albert", n=n, m=m, seed=seed))
    np.testing.assert_array_equal(ours.adj, theirs.adj)


OVERLAYS = {"erdos_renyi": dict(n=10, seed=3), "watts_strogatz": dict(n=12, seed=2),
            "barabasi_albert": dict(n=10, seed=3), "complete": dict(n=6, seed=0)}


@pytest.mark.parametrize("kind", sorted(OVERLAYS))
@pytest.mark.parametrize("protocol", PROTOCOL_NAMES)
def test_measure_policy_matches_the_reference(protocol, kind):
    assert PROTOCOL_NAMES == JAX_PROTOCOL_NAMES
    g = make_topology(TopologySpec(kind=kind, **OVERLAYS[kind]))
    g_ref = jax_make_topology(JaxTopologySpec(kind=kind, **OVERLAYS[kind]))
    ours = measure_policy(make_policy(protocol, g, n_segments=3))
    theirs = jax_measure_policy(jax_make_policy(protocol, g_ref, n_segments=3))
    assert ours == theirs
    assert make_policy(protocol, g).payload_fraction == \
        jax_make_policy(protocol, g_ref).payload_fraction


def test_exchange_units_count_at_n10():
    g = make_topology(TopologySpec(kind="erdos_renyi", n=10, seed=3))
    assert measure_policy(make_policy("broadcast_exchange", g))["transmissions"] == 90
    assert measure_policy(make_policy("mosgu_exchange", g))["transmissions"] == 18


@pytest.mark.parametrize("name", ("codec_x_protocol", "table3_full"))
def test_sweep_totals_match_the_reference_plan_executor(name):
    ours = run_sweep(scenarios.get_sweep(name)).table()
    theirs = jax_run_sweep(jax_scenarios.get_sweep(name), executor="plan").table()
    keys = ("cell", "scenario", "protocol", "payload_mb", "rounds", "transmissions",
            "bytes_mb", "bytes_on_wire_mb", "slots", "drops")
    assert [{k: r[k] for k in keys} for r in ours] == [{k: r[k] for k in keys} for r in theirs]
    assert all(r["time_s"] is None for r in ours)


@pytest.mark.parametrize("name", DRY_TABLES)
def test_dry_table_prints_the_reference_lines(name, capsys):
    assert main(["--sweep", name]) is None
    ours = capsys.readouterr().out
    rc, theirs, err = _reference("--sweep", name)
    assert rc == 0, err[-2000:]
    assert ours.splitlines() == theirs.splitlines()
    assert len(ours.splitlines()) == 1 + scenarios.get_sweep(name).n_cells


def test_async_vs_sync_raises_the_capability_error():
    with pytest.raises(ValueError, match="executor 'plan' lacks capability "
                                         "'supports_staleness' \\(compute_time_s=5.0, "
                                         "compute_jitter_s=4.0\\) required by scenario "
                                         "'async_vs_sync/max_staleness=0,protocol=mosgu,"
                                         "underlay=paper_lan'"):
        main(["--sweep", "async_vs_sync"])


def test_optimized_vs_mst_raises_by_name():
    with pytest.raises(ValueError, match="optimizer\\[1\\]' declares an overlay optimizer: "
                                         "its plan needs repro.opt's annealed overlay, "
                                         "not ported"):
        main(["--sweep", "optimized_vs_mst"])


def test_exchange_cell_raises_the_reference_gossip_mode_error(capsys):
    with pytest.raises(ValueError) as exc:
        main(["--smoke", "--sweep", "table3_full", "--cell", "0", "--device", "cpu"])
    ours = capsys.readouterr().out.splitlines()
    rc, theirs, err = _reference("--smoke", "--sweep", "table3_full", "--cell", "0")
    assert rc != 0
    assert ours == theirs.splitlines() == [
        "sweep 'table3_full' cell 0: table3_full/topology=complete,payload=v3s,"
        "protocol=broadcast_exchange"]
    want = ("scenario protocol 'broadcast_exchange' has no",
            "gossip mode; known: ['dissemination', 'flooding', 'mosgu', 'segmented', "
            "'segmented_gossip', 'tree_allreduce']")
    assert all(w in str(exc.value) and w in err for w in want)


@pytest.mark.parametrize("argv,message", [
    (["--sweep", "table3_full", "--cell", "99"], "--cell 99 outside [0, 32) for sweep "
                                                 "'table3_full'"),
    (["--cell", "3"], "--cell is an index into --sweep"),
    (["--sweep", "codec_x_protocol", "--scenario", "paper_table3"], "mutually exclusive"),
])
def test_bad_cell_arguments_exit(argv, message):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert message in str(exc.value)
