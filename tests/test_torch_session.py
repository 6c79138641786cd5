"""The port's DFL session (``repro_torch.dfl.session.DFLSession``) against the
JAX package's, and the port's copies of the moderator and the data pipeline
against the originals.

* The same churn script on both sides (node 3 leaves after round 0 and
  rejoins after round 1; tests/test_session.py's script): the members, the
  moderator after every round, the plan's live-node count, colors and
  transmissions, and the loss, from the same init and batch (the JAX
  session on 4 forced host devices with an Auto-axis mesh, ROADMAP R1).
* The masked node keeps its own parameters through a gossip round (as
  tests/test_session.py asks of the reference's collectives): node 3 ends
  the round exactly where a round without gossip leaves it, the members at
  the FedAvg of theirs.
* Scheduled churn: a scenario's leave fires at its round; an event naming a
  node past the session's nodes is skipped with a warning.
* ``core/moderator.py`` and ``data/pipeline.py``: equal outputs to the
  originals (schedule packets, votes, handover; token streams bit for bit).
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import moderator as jax_moderator  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import FederatedData as JaxFederatedData  # noqa: E402
from repro_torch.checkpoint import restore_pytree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import moderator as pt_moderator  # noqa: E402
from repro_torch.data import DataConfig, FederatedData  # noqa: E402
from repro_torch.dfl.collectives import tree_map  # noqa: E402
from repro_torch.dfl.session import DFLSession  # noqa: E402
from repro_torch.dfl.trainer import DFLConfig, DFLTrainer, TrainState  # noqa: E402
from repro_torch.models import Batch, build_model  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.scenario.spec import ChurnEvent, get as get_scenario  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


JAX_SESSION = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.checkpoint import save_pytree
    from repro.configs import get_arch
    from repro.dfl import DFLConfig, DFLTrainer
    from repro.dfl.session import DFLSession
    from repro.models import Batch, build_model

    out_dir = sys.argv[1]
    mesh = jax.make_mesh((4, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    cfg = get_arch("smollm-360m").smoke_variant()
    trainer = DFLTrainer(build_model(cfg), mesh, DFLConfig(gossip_mode="tree_allreduce",
                                                           lr=1e-3, warmup=0))
    session = DFLSession(trainer)
    state = trainer.init_state(jax.random.PRNGKey(0))
    save_pytree(f"{out_dir}/init_params", jax.device_get(state.params))
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (8, 32)).astype(np.int32)
    batch = Batch(tokens=jnp.asarray(tok), labels=jnp.asarray(tok))
    rounds = [{"moderator": session.moderator.moderator_id}]
    script = [None, ("leave", 3), ("rejoin", 3)]
    for action in script:
        if action and action[0] == "leave":
            session.node_leaves(action[1])
        elif action:
            session.node_rejoins(action[1])
        state, m = session.train_round(state, batch)
        plan = session.trainer.plan
        rounds.append({"members": sorted(session.members), "loss": float(m["loss"]),
                       "moderator": session.moderator.moderator_id, "n_nodes": plan.n_nodes,
                       "colors": [int(c) for c in np.asarray(plan.colors)],
                       "diss_tx": plan.dissemination.total_transmissions(),
                       "tree_tx": plan.tree.total_transmissions()})
    json.dump({"tokens": tok.tolist(), "rounds": rounds}, open(f"{out_dir}/session.json", "w"))
""")


@pytest.fixture(scope="module")
def jax_session(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_session")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", JAX_SESSION, str(out)], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out, json.load(open(out / "session.json"))


def _session():
    cfg = get_arch("smollm-360m").smoke_variant()
    model = build_model(cfg, device="cpu")
    trainer = DFLTrainer(model, N, DFLConfig(gossip_mode="tree_allreduce", lr=1e-3, warmup=0),
                         device="cpu")
    return model, trainer, DFLSession(trainer)


def test_session_churn_and_rotation_match_jax(jax_session):
    out, ref = jax_session
    model, trainer, session = _session()
    init = restore_pytree(str(out / "init_params.npz"), model.init(torch.Generator()))
    state = trainer.state_from_params(init)
    tok = torch.tensor(ref["tokens"]).long()
    batch = Batch(tokens=tok, labels=tok)
    rounds = [{"moderator": session.moderator.moderator_id}]
    for action in (None, ("leave", 3), ("rejoin", 3)):
        if action and action[0] == "leave":
            session.node_leaves(action[1])
            assert session.trainer.plan.n_nodes == N  # stale until the next round plans
        elif action:
            session.node_rejoins(action[1])
        state, m = session.train_round(state, batch)
        plan = session.trainer.plan
        rounds.append({"members": sorted(session.members), "loss": float(m["loss"]),
                       "moderator": session.moderator.moderator_id, "n_nodes": plan.n_nodes,
                       "colors": [int(c) for c in plan.colors],
                       "diss_tx": plan.dissemination.total_transmissions(),
                       "tree_tx": plan.tree.total_transmissions()})
    assert [r["n_nodes"] for r in rounds[1:]] == [4, 3, 4]
    assert sum(c < 0 for c in rounds[2]["colors"]) == 1
    assert rounds[0]["moderator"] != rounds[1]["moderator"]  # rotated
    for got, want in zip(rounds, ref["rounds"]):
        loss_g, loss_w = got.pop("loss", None), want.pop("loss", None)
        assert got == want
        if loss_w is not None:
            assert abs(loss_g - loss_w) <= 1e-5 * abs(loss_w)


def test_masked_node_keeps_its_own_params_through_the_round():
    model, trainer, session = _session()
    state = trainer.init_state(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    bump = tree_map(lambda t: torch.randn(t.shape[1:], generator=g) * 1e-2, state.params)
    for tree in (state.params, state.opt_state["master"]):  # node 3 drifts apart
        tree_map(lambda t, b: t[3].add_(b), tree, bump)
    tok = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (8, 32))).long()
    batch = Batch(tokens=tok, labels=tok)
    session.node_leaves(3)
    solo = DFLTrainer(model, N, DFLConfig(lr=1e-3, warmup=0, gossip_interval=10 ** 9),
                      device="cpu")
    # the same step with no gossip, on a copy (a step consumes its input state)
    copy = TrainState(params=tree_map(torch.clone, state.params),
                      opt_state=tree_map(torch.clone, state.opt_state), step=state.step.clone())
    alone, _ = solo.train_step(copy, batch)
    state, _ = session.train_round(state, batch)
    for got, local in zip(tree_leaves(state.opt_state["master"]),
                          tree_leaves(alone.opt_state["master"])):
        assert torch.equal(got[3], local[3])  # the masked node: untouched by gossip
        mean = local[:3].double().mean(dim=0)
        assert float((got[:3].double() - mean).abs().max()) <= 1e-6
        assert float((got[3] - got[0]).abs().max()) > 0


def test_scheduled_churn_fires_at_its_round_and_skips_what_cannot():
    model, trainer, _ = _session()
    spec = get_scenario("mesh_smoke")
    spec = spec.replace(churn=(*spec.churn, ChurnEvent(1, "leave", 9)))
    session = DFLSession(trainer, scenario=spec)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (8, 32))).long()
    batch = Batch(tokens=tok, labels=tok)
    state, _ = session.train_round(state, batch)
    assert session.members == set(range(N))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        session.train_round(state, batch)
    leaves = [ev.node for ev in spec.churn if ev.round == 1 and ev.action == "leave"]
    assert session.members == set(range(N)) - set(leaves[:-1])
    assert session.trainer.plan.n_nodes == N - len(leaves[:-1])
    assert any("skipped" in str(w.message) for w in caught)


# -- the copied numpy modules ----------------------------------------------------------

def _reports(mod, n, seed):
    rng = np.random.default_rng(seed)
    costs = rng.uniform(1, 10, (n, n))
    return [mod.ConnectivityReport(u, f"node{u}", {v: float(costs[u, v])
                                                   for v in range(n) if v != u})
            for u in range(n)]


@pytest.mark.parametrize("n,seed", [(4, 0), (7, 1), (12, 2)])
def test_moderator_copy_matches_the_original(n, seed):
    mods = [mod.Moderator(0, protocol="segmented", n_segments=3)
            for mod in (pt_moderator, jax_moderator)]
    for mod, m in zip((pt_moderator, jax_moderator), mods):
        for r in _reports(mod, n, seed):
            m.receive_report(r)
    packets = [m.compute_schedule(21.2) for m in mods]
    assert np.array_equal(packets[0].colors, packets[1].colors)
    assert packets[0].neighbor_table == packets[1].neighbor_table
    assert packets[0].slot_length_s == pytest.approx(packets[1].slot_length_s, rel=1e-12)
    assert (packets[0].version, packets[0].protocol, packets[0].n_segments) == \
        (packets[1].version, packets[1].protocol, packets[1].n_segments)
    for m in mods:
        m.remove_node(n - 1)
    votes = {u: (u * 3) % (n - 1) for u in range(n - 1)}
    assert mods[0].elect_next(votes) == mods[1].elect_next(votes)
    assert mods[0].elect_next({}) == mods[1].elect_next({})
    nxt = [m.handover(m.elect_next(votes)) for m in mods]
    assert nxt[0].members == nxt[1].members and nxt[0].moderator_id == nxt[1].moderator_id
    again = [m.compute_schedule(5.3) for m in nxt]
    assert np.array_equal(again[0].colors, again[1].colors)
    assert again[0].slot_length_s == pytest.approx(again[1].slot_length_s, rel=1e-12)


@pytest.mark.parametrize("vocab,seq,bpn,n,seed", [(512, 32, 2, 4, 0), (49152, 64, 3, 5, 7)])
def test_pipeline_copy_gives_the_same_streams(vocab, seq, bpn, n, seed):
    ours = FederatedData(DataConfig(vocab=vocab, seq_len=seq, batch_per_node=bpn, n_nodes=n,
                                    seed=seed))
    theirs = JaxFederatedData(JaxDataConfig(vocab=vocab, seq_len=seq, batch_per_node=bpn,
                                            n_nodes=n, seed=seed))
    for _ in range(3):
        for a, b in zip(ours.global_batch(), theirs.global_batch()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
