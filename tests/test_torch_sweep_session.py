"""Sweep cells trained by the port's launcher against the JAX session.

Two cells at smoke width on 4 nodes, each with the ``DFLConfig`` that each
launcher builds for ``--cell K`` (lr 1e-3, ``total_steps`` the cell's
rounds, the cell's codec, the warm-up left at its default of 100):

* ``codec_x_protocol`` cell 7: int4 on the segmented protocol, one round;
* ``async_vs_sync`` cell 6: flooding (staleness 0, paper_lan), 8 rounds.

The JAX side runs ``DFLSession(trainer, scenario=cell.spec)`` on an
Auto-axis mesh of 4 forced host devices (ROADMAP R1) and saves its init
params; the port restores them into :func:`repro_torch.launch.train.build_run`'s
run and trains it through :func:`~repro_torch.launch.train.train`. Each
round's loss must fall within 1e-5 relative of the JAX session's (the
tolerance of tests/test_torch_session.py). The flooding cell fails under
the launcher's former ``--warmup 0`` default: its losses part from round 2
on (checked below), because the reference's warm-up gives lr 0 at step 0
and a small lr after it.

The launcher's header lines for ``--cell K`` are the reference launcher's
(its f-strings over the reference's own cells). The scenario runner's
``fedavg_check`` (the FedAvg check of ``chip_smoke.py``'s phase 6) passes
for a segmented int4 cell on 10 unequal nodes and fails when the round
skips its gossip.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.scenario import scenarios as jax_scenarios  # noqa: E402
from repro_torch.checkpoint import restore_pytree  # noqa: E402
from repro_torch.dfl.collectives import tree_flatten  # noqa: E402
from repro_torch.launch.train import build_run, parse_args, resolve_scenario, train  # noqa: E402
from repro_torch.scenario.runner import fedavg_check  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = (("codec_x_protocol", 7), ("async_vs_sync", 6))
SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


JAX_CELL = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.checkpoint import save_pytree
    from repro.configs import get_arch
    from repro.data import DataConfig, FederatedData
    from repro.dfl import DFLConfig, DFLTrainer
    from repro.dfl.session import DFLSession
    from repro.models import Batch, build_model
    from repro.scenario import resolve_gossip_mode, scenarios

    out_dir, sweep, cell, seq = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    spec = scenarios.get_sweep(sweep).cells()[cell].spec
    cfg = get_arch("smollm-360m").smoke_variant()
    mesh = jax.make_mesh((4, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    codec = spec.codec if spec.codec != "fp32" else ""
    # the reference launcher's DFLConfig for --cell K: warmup at its default
    dfl = DFLConfig(gossip_mode=resolve_gossip_mode(spec.protocol), gossip_interval=1,
                    lr=1e-3, total_steps=spec.rounds, codec=codec)
    trainer = DFLTrainer(build_model(cfg), mesh, dfl)
    state = trainer.init_state(jax.random.PRNGKey(0))
    save_pytree(f"{out_dir}/init_params", jax.device_get(state.params))
    data = FederatedData(DataConfig(vocab=cfg.vocab, seq_len=seq, batch_per_node=2, n_nodes=4))

    def make_batch():
        tok, lab = data.global_batch()
        return Batch(tokens=jnp.asarray(tok), labels=jnp.asarray(lab))

    session = DFLSession(trainer, scenario=spec)
    batch, losses = make_batch(), []
    for _ in range(spec.rounds):  # run_scenario_rounds' loop
        state, m = session.train_round(state, batch)
        batch = make_batch()
        losses.append(float(m["loss"]))
    json.dump({"losses": losses, "warmup": dfl.warmup, "mode": dfl.gossip_mode,
               "codec": dfl.codec, "total_steps": dfl.total_steps},
              open(f"{out_dir}/cell.json", "w"))
""")


_JAX_RUNS = {}


def _jax_cell(sweep, cell, tmp_path_factory):
    """The JAX session's run of a cell (once a cell): its directory (with
    ``init_params.npz``) and its ``cell.json``."""
    if (sweep, cell) not in _JAX_RUNS:
        out = tmp_path_factory.mktemp(f"{sweep}{cell}")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        proc = subprocess.run([sys.executable, "-c", JAX_CELL, str(out), sweep, str(cell),
                               str(SEQ)], capture_output=True, text=True, env=env, timeout=900)
        assert proc.returncode == 0, proc.stderr[-3000:]
        _JAX_RUNS[sweep, cell] = out, json.load(open(out / "cell.json"))
    return _JAX_RUNS[sweep, cell]


def _port_cell(sweep, cell, init_dir, *extra):
    """The port's launcher run of the cell, from the JAX session's init."""
    args = parse_args(["--smoke", "--nodes", "4", "--seq-len", str(SEQ), "--sweep", sweep,
                       "--cell", str(cell), "--device", "cpu", *extra])
    done, spec = resolve_scenario(args)
    assert not done
    run = build_run(args, spec)
    init = restore_pytree(str(init_dir / "init_params.npz"),
                          run.model.init(torch.Generator().manual_seed(0)))
    run.state = run.trainer.state_from_params(init)
    return train(run)


@pytest.mark.parametrize("sweep,cell", CELLS)
def test_cell_trains_as_the_jax_session(sweep, cell, tmp_path_factory):
    out, ref = _jax_cell(sweep, cell, tmp_path_factory)
    run = _port_cell(sweep, cell, out)
    dfl = run.trainer.dfl
    assert (dfl.warmup, dfl.gossip_mode, dfl.codec, dfl.total_steps, dfl.lr) == \
        (ref["warmup"], ref["mode"], ref["codec"], ref["total_steps"], 1e-3)
    assert ref["warmup"] == 100 and ref["total_steps"] == run.scenario.rounds
    assert len(run.losses) == len(ref["losses"]) == run.scenario.rounds
    np.testing.assert_allclose(run.losses, ref["losses"], rtol=1e-5)


def test_flooding_cell_parts_from_the_reference_without_the_warmup(tmp_path_factory):
    out, ref = _jax_cell("async_vs_sync", 6, tmp_path_factory)
    run = _port_cell("async_vs_sync", 6, out, "--warmup", "0")
    np.testing.assert_allclose(run.losses[:1], ref["losses"][:1], rtol=1e-5)
    rel = np.abs(np.subtract(run.losses, ref["losses"])) / np.abs(ref["losses"])
    assert (rel[2:] > 1e-3).all(), rel


@pytest.mark.parametrize("sweep,cell", [("codec_x_protocol", 7), ("codec_x_protocol", 0),
                                        ("async_vs_sync", 6), ("wan_sweep", 11)])
def test_cell_prints_the_reference_header(sweep, cell, capsys):
    spec = jax_scenarios.get_sweep(sweep).cells()[cell].spec
    args = parse_args(["--sweep", sweep, "--cell", str(cell)])
    resolve_scenario(args)
    assert capsys.readouterr().out.splitlines() == [
        f"sweep {sweep!r} cell {cell}: {spec.name}",
        f"cell scenario: protocol={spec.protocol} codec={spec.codec} rounds={spec.rounds}"]
    assert args.steps == spec.rounds


@pytest.mark.parametrize("gossip", (True, False), ids=("gossip", "no-gossip"))
def test_fedavg_check_from_unequal_nodes_can_fail(gossip):
    args = parse_args(["--arch", "whisper-tiny", "--smoke", "--nodes", "10", "--seq-len", "16",
                       "--sweep", "codec_x_protocol", "--cell", "7", "--device", "cpu"])
    _, spec = resolve_scenario(args)
    run = build_run(args, spec)
    if not gossip:
        run.trainer.gossip = lambda params, opt_state: (params, opt_state)
    before = [t.clone() for t in tree_flatten(run.state.params)[0]]
    ok, finite, worst, times = fedavg_check(run.trainer, run.state, run.make_batch(),
                                            session=run.session)
    assert finite
    # the check steps a clone: the run's state and the trainer's timing stay
    assert all(torch.equal(a, b) for a, b in zip(before, tree_flatten(run.state.params)[0]))
    assert int(run.state.step) == 0 and run.trainer.timed is False
    assert ok is gossip, worst
    assert (worst < 0.05) is gossip  # the seeded offsets are 0.01 x N(0, 1) a node
    assert set(times) == {"fwd_bwd", "optimizer", "gossip"}
