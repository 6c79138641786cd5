"""The port's card executor against the JAX package's ``jax`` executor.

``run_scenario(name, executor=DeviceExecutor(device="cpu", proxy_elems=4))``
must report, round for round, the same ``n_slots``, ``transmissions``,
``bytes_mb``, ``bytes_on_wire_mb`` and ``numerics_ok``. The JAX side runs in one
subprocess with 12 forced host devices, which also writes a stacked
parameter tree (with a ``codec_ef`` residual tree and a bfloat16 leaf) for
the ``convert`` round trip.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.scenario import scenarios  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.scenario import SCENARIOS, DeviceExecutor, run_scenario  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("paper_table3", "quantized_table3", "topk_sweep", "mesh_smoke", "churn_storm")
FIELDS = ("n_slots", "transmissions", "bytes_mb", "bytes_on_wire_mb", "numerics_ok")


def _cpu_run(spec):
    """The card executor on the CPU at the JAX executor's proxy size: its
    card view (:class:`~repro_torch.scenario.ScenarioRun`)."""
    ex = DeviceExecutor(device="cpu", proxy_elems=4)
    run_scenario(spec, executor=ex)
    return ex.run

JAX_SIDE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.scenario import run_scenario, scenarios

    out_json, out_npz, names = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
    reports = {}
    for name in names:
        res = run_scenario(scenarios.get(name), executor="jax")
        reports[name] = [{"members": r.members, "n_slots": r.n_slots,
                          "transmissions": r.transmissions, "bytes_mb": r.bytes_mb,
                          "bytes_on_wire_mb": r.bytes_on_wire_mb,
                          "numerics_ok": r.numerics_ok} for r in res.rounds]
    json.dump(reports, open(out_json, "w"))
    # a stacked per-node state as the JAX trainer holds it: P("data") leaves
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
    sh = NamedSharding(mesh, P("data"))
    rng = np.random.default_rng(5)
    state = {
        "params": {"embed": jax.device_put(rng.normal(size=(4, 33, 8)).astype(np.float32), sh),
                   "norm": jax.device_put(jnp.asarray(rng.normal(size=(4, 8)), jnp.bfloat16), sh)},
        "codec_ef": {"embed": jax.device_put(rng.normal(size=(4, 33, 8)).astype(np.float32), sh)},
    }
    np.savez(out_npz, **{f"{g}/{k}": np.asarray(v) for g, leaves in state.items()
                         for k, v in leaves.items()})
""")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_runner")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=12")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, str(tmp / "r.json"), str(tmp / "s.npz"),
         ",".join(NAMES)], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads((tmp / "r.json").read_text()), tmp / "s.npz"


@pytest.mark.parametrize("name", NAMES)
def test_round_reports_match_jax_executor(name, jax_side):
    theirs = jax_side[0][name]
    ours = _cpu_run(name)
    assert len(ours.rounds) == len(theirs)
    for r, t in zip(ours.rounds, theirs):
        assert r.members == t["members"]
        for f in FIELDS:
            assert getattr(r, f) == t[f], (name, r.round, f)
        assert r.finite and r.device_ms is None


@pytest.mark.parametrize("name", NAMES)
def test_scenario_table_matches_registry(name):
    reg, ours = scenarios.get(name), SCENARIOS[name]
    assert ours.payload_mb() == reg.payload_mb()
    for f in ("protocol", "n_segments", "codec", "rounds"):
        assert getattr(ours, f) == getattr(reg, f)
    assert [(e.round, e.action, e.node) for e in ours.churn] == \
        [(e.round, e.action, e.node) for e in reg.churn]
    for f in ours.overlay.__dataclass_fields__:
        assert getattr(ours.overlay, f) == getattr(reg.overlay, f), f
    assert reg.underlay is None and reg.optimizer is None and reg.drop_rate == 0
    assert (reg.mst_algorithm, reg.coloring_algorithm) == ("prim", "bfs")


def test_membership_matches_jax_lifecycle():
    from repro.scenario.executors import membership_rounds
    from repro_torch.scenario.executors import membership_rounds as port_rounds

    for name in NAMES:
        reg, ours = scenarios.get(name), SCENARIOS[name]
        theirs = [(r, mod.moderator_id, tuple(m))
                  for r, mod, m, _ in membership_rounds(reg, reg.overlay_graph())]
        assert [(r, mod.moderator_id, tuple(m))
                for r, mod, m, _ in port_rounds(ours, ours.overlay_graph())] == theirs
        assert [tuple(r.members) for r in _cpu_run(name).rounds] == [m for _, _, m in theirs]


@pytest.mark.parametrize("protocol", ("dissemination", "segmented", "tree_allreduce",
                                      "flooding"))
@pytest.mark.parametrize("name", NAMES)
def test_round_counts_are_the_plan_executors(name, protocol):
    """The card executor's members, slots, transmissions and bytes are the
    plan executor's, but for flooding, which the device runs as an all-gather:
    m (m - 1) sends of the whole payload in one slot, m the live nodes."""
    from repro_torch.compress import per_send_wire_mb
    from repro_torch.scenario.executors import PlanExecutor

    base = SCENARIOS[name]
    spec = base.replace(protocol=protocol, codec="int4",
                        churn=() if protocol == "flooding" else base.churn)
    counted = PlanExecutor().execute(spec).rounds
    ours = _cpu_run(spec).rounds
    assert [r.members for r in ours] == [c.members for c in counted]
    for r, c in zip(ours, counted):
        if protocol == "flooding":
            m = len(r.members)
            assert (r.n_slots, r.transmissions) == (1, m * (m - 1))
            assert r.bytes_mb == r.transmissions * spec.payload_mb()
            assert r.bytes_on_wire_mb == r.transmissions * per_send_wire_mb(
                spec.codec_obj(), spec.payload_mb())
        else:
            for f in ("n_slots", "transmissions", "bytes_mb", "bytes_on_wire_mb"):
                assert getattr(r, f) == getattr(c, f), (r.round, f)
        assert r.numerics_ok and r.finite


def test_convert_round_trips_a_jax_stacked_tree(jax_side):
    import ml_dtypes

    data = np.load(jax_side[1])
    tree = {}
    for key in data.files:
        group, leaf = key.split("/")
        arr = data[key]
        if arr.dtype.kind == "V":  # .npz keeps bfloat16 as raw 2-byte records
            arr = arr.view(ml_dtypes.bfloat16)
        tree.setdefault(group, {})[leaf] = arr
    tensors = convert.from_numpy(tree, device="cpu")
    assert tensors["params"]["norm"].dtype == torch.bfloat16
    assert tensors["params"]["embed"].shape == (4, 33, 8)
    back = convert.to_numpy(tensors)
    for group, leaves in tree.items():
        for k, v in leaves.items():
            assert back[group][k].dtype == v.dtype
            np.testing.assert_array_equal(back[group][k].view(np.uint8), v.view(np.uint8))


def test_entry_points_raise_without_a_card():
    """An entry point without ``device="cpu"`` runs on the card, and there is
    none here: it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario("quantized_table3", executor=DeviceExecutor(proxy_elems=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.from_numpy({"w": np.zeros((2, 3), np.float32)})


def test_cli_prints_one_report_per_round():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.scenario", "--scenario", "topk_sweep",
         "--device", "cpu", "--proxy-elems", "300"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert [r["round"] for r in rows] == [0, 1, 2]
    assert all(r["bytes_on_wire_mb"] == 127.96992 and r["finite"] for r in rows)
