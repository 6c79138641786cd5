"""The port's DFL training step against the JAX package's, on the CPU.

* ``Model.train_loss`` gradients against ``jax.grad`` of the JAX model on the
  same params (converted leaf for leaf) and tokens, for the f32 smoke
  variants of smollm-360m, granite-3-2b, gemma2-2b (s above its window),
  falcon-mamba-7b, qwen3-moe-30b-a3b, arctic-480b, stablelm-12b and
  zamba2-7b: within 1e-4 of each leaf's max |g| (attention, scan and
  matmuls sum in another order than XLA).
* One DFL step of the port on 4 stacked nodes against the JAX ``DFLTrainer``
  on 4 forced host devices with an Auto-axis mesh (ROADMAP R1), from the
  same init and batch: loss within 1e-5 relative, grad_norm within 1e-4
  relative, every node's params and masters within 0.1 lr of the
  reference's (Adam's first step moves an element by lr g / |g|, so a
  gradient near 0 can move it by a fraction of lr either way). The
  ``gossip_interval=2`` path likewise over two steps.
* The moe family (P4's aux half): one step of qwen3-moe-30b-a3b's smoke
  variant at 1 and 2 microbatches and of arctic-480b's (8 microbatches,
  Adafactor, no fp32 masters) against the JAX ``DFLTrainer``. The reference
  takes the Switch aux loss over each microbatch slice of the global batch,
  which differs from the mean of the nodes' own aux losses by more than the
  loss tolerance (the fixture checks it). Loss within 1e-5 relative, grad
  norm within 1e-4 relative, the first moment (AdamW) or the factored
  second moment (Adafactor) within 1e-4 of each leaf's max, the params
  within 1e-4 of each leaf's max (Adafactor) or 0.1 lr (AdamW, as above);
  the routing pass and the differentiated pass route alike. The hybrid
  family likewise: one step of zamba2-7b's smoke variant (Mamba2 blocks and
  the shared attention block, AdamW) against the JAX ``DFLTrainer``. And
  the frontend families: one step of whisper-tiny's and paligemma-3b's
  smoke variants at 1 and 2 microbatches, with seeded frames or patches
  that differ by row, so a trainer that dropped them or split them other
  than by the tokens' rows would read other inputs than the reference's.
* R9: the reference's Adam moments are identical on every node device and
  equal (1 - b1) times the clipped mean of the nodes' own gradients, which
  differ; the port holds the moments once and matches them.
* The port alone: per-node reductions do not mix nodes (each node's
  gradient is its own, the step's is their mean, Adafactor's and AdamW's
  stacked updates equal per-node updates), microbatches match one batch,
  the three exact gossip modes agree within 1e-5 after one step (the bound
  of tests/test_system.py), the loss falls over 14 steps, and error-feedback
  top-k carries its residual and learns (tests/test_codec.py).

The JAX references run in one subprocess (4 forced host devices), which
writes an ``.npz`` a module-scoped fixture reads.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import Batch as JaxBatch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.checkpoint import restore_pytree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.data import DataConfig, FederatedData  # noqa: E402
from repro_torch.dfl.collectives import tree_map  # noqa: E402
from repro_torch.dfl.trainer import DFLConfig, DFLTrainer, TrainState  # noqa: E402
from repro_torch.models import Batch, build_model  # noqa: E402
from repro_torch.models.model import MOE_AUX_WEIGHT  # noqa: E402
from repro_torch.optim import adafactor, adamw, constant_schedule  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("smollm-360m", "granite-3-2b", "gemma2-2b", "falcon-mamba-7b", "qwen3-moe-30b-a3b",
         "arctic-480b", "stablelm-12b", "zamba2-7b")
SEQ = {"gemma2-2b": 160}  # above the smoke window of 128
N, BPN, S, LR = 4, 2, 32, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small models: more threads only contend on a shared machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _close_per_leaf(got, want, rel):
    for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
        g = g.detach().cpu().double().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w, dtype=np.float64)
        assert g.shape == w.shape, name
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= rel * max(scale, 1e-30), f"{name}: {err} > {rel} x {scale}"


# -- train_loss gradients against jax.grad -----------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_grads_match_jax(arch):
    cfg_j = jax_configs.get_arch(arch).smoke_variant()
    mj = jax_build_model(cfg_j)
    params_j = mj.init(jax.random.PRNGKey(0))
    mt = build_model(get_arch(arch).smoke_variant(), device="cpu")
    params_t = tree_map(lambda t: t.requires_grad_(True), from_numpy(params_j, device="cpu"))
    s = SEQ.get(arch, 64)
    g = np.random.default_rng(3)
    tok = g.integers(0, cfg_j.vocab, (2, s)).astype(np.int32)
    lab = g.integers(0, cfg_j.vocab, (2, s)).astype(np.int32)
    lab[0, :5] = -1  # masked positions
    loss_j, grads_j = jax.value_and_grad(mj.train_loss)(
        params_j, JaxBatch(tokens=jax.numpy.asarray(tok), labels=jax.numpy.asarray(lab)))
    loss_t = mt.train_loss(params_t, Batch(tokens=torch.from_numpy(tok).long(),
                                           labels=torch.from_numpy(lab).long()))
    grads_t = torch.autograd.grad(loss_t, [t for _, t in _leaves(params_t)])
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    for (name, w), g in zip(_leaves(jax.device_get(grads_j)), grads_t):
        w = np.asarray(w, dtype=np.float64)
        err, scale = float(np.abs(g.double().numpy() - w).max()), float(np.abs(w).max())
        assert err <= 1e-4 * max(scale, 1e-30), f"{name}: {err} > 1e-4 x {scale}"


# -- the reference trainer, in one subprocess ------------------------------------------

JAX_REF = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.checkpoint import save_pytree
    from repro.configs import get_arch
    from repro.data import DataConfig, FederatedData
    from repro.dfl import DFLConfig, DFLTrainer
    from repro.models import Batch, build_model
    from repro.optim.optimizers import clip_by_global_norm

    out_dir, n, bpn, s, lr = sys.argv[1], 4, 2, 32, 1e-3
    mesh = jax.make_mesh((n, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    cfg = get_arch("smollm-360m").smoke_variant()
    model = build_model(cfg)
    data = FederatedData(DataConfig(vocab=cfg.vocab, seq_len=s, batch_per_node=bpn, n_nodes=n))
    batches = [data.global_batch() for _ in range(2)]
    res = {}
    for i, (tok, lab) in enumerate(batches):
        res[f"tokens{i}"], res[f"labels{i}"] = tok, lab

    def spread(tree):
        worst = 0.0
        for leaf in jax.tree.leaves(tree):
            sh = [np.asarray(x.data) for x in leaf.addressable_shards]
            assert len(sh) == n and all(x.shape == leaf.shape for x in sh)
            worst = max(worst, max(float(np.abs(x - sh[0]).max()) for x in sh))
        return worst

    for run, mode, interval, steps in (("tree", "tree_allreduce", 1, 1),
                                       ("interval2", "tree_allreduce", 2, 2)):
        tr = DFLTrainer(model, mesh, DFLConfig(gossip_mode=mode, gossip_interval=interval,
                                               lr=lr, warmup=0))
        state = tr.init_state(jax.random.PRNGKey(0))
        if run == "tree":
            save_pytree(f"{out_dir}/init_params", jax.device_get(state.params))
        for i in range(steps):
            tok, lab = batches[i]
            batch = Batch(tokens=jnp.asarray(tok), labels=jnp.asarray(lab))
            step = tr.jitted_train_step(jax.eval_shape(lambda: state),
                                        jax.eval_shape(lambda: batch))
            state, m = step(state, batch)
            res[f"{run}/loss{i}"] = float(m["loss"])
            res[f"{run}/grad_norm{i}"] = float(m["grad_norm"])
        res[f"{run}/spread_params"] = spread(state.params)
        res[f"{run}/spread_m"] = spread(state.opt_state["m"])
        res[f"{run}/spread_v"] = spread(state.opt_state["v"])
        for k in ("m", "v", "master"):
            save_pytree(f"{out_dir}/{run}_{k}", jax.device_get(state.opt_state[k]))
        save_pytree(f"{out_dir}/{run}_params", jax.device_get(state.params))

    # R9: each node's own gradient at the init params on its own rows, and
    # (1 - b1) x the clipped mean, which the tree run's first moment must be
    init = jax.device_get(DFLTrainer(model, mesh, DFLConfig()).init_state(
        jax.random.PRNGKey(0)).params)
    tok, lab = batches[0]
    grad = jax.jit(jax.grad(model.train_loss))
    node_g = [grad(init, Batch(tokens=jnp.asarray(tok[i * bpn:(i + 1) * bpn]),
                               labels=jnp.asarray(lab[i * bpn:(i + 1) * bpn])))
              for i in range(n)]
    mean = jax.tree.map(lambda *g: sum(g) / n, *node_g)
    clipped, _ = clip_by_global_norm(mean, 1.0)
    save_pytree(f"{out_dir}/r9_m_of_mean", jax.tree.map(lambda g: 0.1 * g, clipped))
    own0, _ = clip_by_global_norm(node_g[0], 1.0)
    save_pytree(f"{out_dir}/r9_m_of_node0", jax.tree.map(lambda g: 0.1 * g, own0))
    res["r9/node_grad_diff"] = max(float(jnp.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(node_g[0]), jax.tree.leaves(node_g[1])))
    res["r9/node_grad_max"] = max(float(jnp.abs(a).max()) for a in jax.tree.leaves(node_g[0]))
    np.savez(f"{out_dir}/ref.npz", **{k: np.asarray(v) for k, v in res.items()})
""")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_trainer")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", JAX_REF, str(out)], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out, dict(np.load(out / "ref.npz"))


def _smoke():
    cfg = get_arch("smollm-360m").smoke_variant()
    return cfg, build_model(cfg, device="cpu")


def _like(model):
    """A tree of the model's param structure (values unused)."""
    return model.init(torch.Generator().manual_seed(0))


def _batch(ref, i):
    return Batch(tokens=torch.from_numpy(ref[f"tokens{i}"]).long(),
                 labels=torch.from_numpy(ref[f"labels{i}"]).long())


def _port_run(jax_ref, mode, interval, steps):
    out, ref = jax_ref
    cfg, model = _smoke()
    like = _like(model)
    init = restore_pytree(str(out / "init_params.npz"), like)
    trainer = DFLTrainer(model, N, DFLConfig(gossip_mode=mode, gossip_interval=interval, lr=LR,
                                             warmup=0), device="cpu")
    opt = trainer.opt.init(init)
    state = train_state_from_numpy(
        tree_map(lambda t: t.numpy(), init), tree_map(lambda t: t.numpy(), opt), 0, N,
        device="cpu")
    metrics = []
    for i in range(steps):
        state, m = trainer.train_step(state, _batch(ref, i))
        metrics.append(m)
    return state, metrics, like, trainer


def test_one_step_matches_jax_trainer(jax_ref):
    out, ref = jax_ref
    state, (m,), like, _ = _port_run(jax_ref, "tree_allreduce", 1, 1)
    assert abs(float(m["loss"]) - ref["tree/loss0"]) <= 1e-5 * abs(ref["tree/loss0"])
    assert abs(float(m["grad_norm"]) - ref["tree/grad_norm0"]) <= 1e-4 * ref["tree/grad_norm0"]
    want_p = restore_pytree(str(out / "tree_params.npz"), like)
    want_m = restore_pytree(str(out / "tree_master.npz"), like)
    for got, want in ((state.params, want_p), (state.opt_state["master"], want_m)):
        for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
            for node in range(N):
                err = float((g[node] - w).abs().max())
                assert err <= 0.1 * LR, f"{name} node {node}: {err}"
    assert int(state.step) == 1 and ref["tree/spread_params"] == 0.0


def test_gossip_interval_2_matches_jax(jax_ref):
    out, ref = jax_ref
    state, metrics, like, _ = _port_run(jax_ref, "tree_allreduce", 2, 2)
    assert [m["gossip"] for m in metrics] == [False, True]
    for i, m in enumerate(metrics):
        want = ref[f"interval2/loss{i}"]
        assert abs(float(m["loss"]) - want) <= 1e-5 * abs(want)
        want = ref[f"interval2/grad_norm{i}"]
        assert abs(float(m["grad_norm"]) - want) <= 1e-4 * want
    want_p = restore_pytree(str(out / "interval2_params.npz"), like)
    for (name, g), (_, w) in zip(_leaves(state.params), _leaves(want_p)):
        assert float((g - w).abs().max()) <= 0.1 * LR, name


def test_adam_moments_equal_across_nodes_r9(jax_ref):
    """The reference's first moment is identical on every node device and
    equals 0.1 x the clipped mean of the nodes' gradients (which differ),
    not any one node's; the port holds the moments once, at that value."""
    out, ref = jax_ref
    assert ref["tree/spread_m"] == 0.0 and ref["tree/spread_v"] == 0.0
    assert ref["r9/node_grad_diff"] > 1e-2 * ref["r9/node_grad_max"]
    state, _, like, trainer = _port_run(jax_ref, "tree_allreduce", 1, 1)
    jax_m = restore_pytree(str(out / "tree_m.npz"), like)
    of_mean = restore_pytree(str(out / "r9_m_of_mean.npz"), like)
    of_node0 = restore_pytree(str(out / "r9_m_of_node0.npz"), like)
    _close_per_leaf(jax_m, tree_map(lambda t: t.numpy(), of_mean), 1e-5)
    gap = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(of_mean),
                                                         tree_leaves(of_node0)))
    assert gap > 1e-3 * max(float(a.abs().max()) for a in tree_leaves(of_mean))
    for (name, got), (_, want) in zip(_leaves(state.opt_state["m"]), _leaves(jax_m)):
        assert got.shape == want.shape, name  # once, no node axis
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name
    # the port's nodes take gradients that differ, as the reference's do
    _, model = _smoke()
    batch = _batch(jax_ref[1], 0)
    init = restore_pytree(str(out / "init_params.npz"), like)
    _, g0 = trainer.node_grads(init, Batch(tokens=batch.tokens[:BPN], labels=batch.labels[:BPN]))
    _, g1 = trainer.node_grads(init, Batch(tokens=batch.tokens[BPN:2 * BPN],
                                           labels=batch.labels[BPN:2 * BPN]))
    diff = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))
    assert abs(diff - ref["r9/node_grad_diff"]) <= 1e-3 * ref["r9/node_grad_diff"]


# -- P4: uneven counts of valid labels over the nodes ---------------------------------

# node 0's rows keep 4 valid labels each, node 1's second row loses 20, node
# 2 has none, node 3 keeps all: the reference's masked mean over the global
# batch (or over each microbatch slice of it) weighs the nodes by their
# counts, not by 1 / N
JAX_P4 = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.checkpoint import save_pytree
    from repro.configs import get_arch
    from repro.data import DataConfig, FederatedData
    from repro.dfl import DFLConfig, DFLTrainer
    from repro.models import Batch, build_model

    out_dir, n, bpn, s, lr = sys.argv[1], 4, 2, 32, 1e-3
    mesh = jax.make_mesh((n, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    base = get_arch("smollm-360m").smoke_variant()
    tok, lab = FederatedData(DataConfig(vocab=base.vocab, seq_len=s, batch_per_node=bpn,
                                        n_nodes=n, seed=4)).global_batch()
    lab = np.array(lab)
    lab[0:2, 4:] = -1
    lab[3, :20] = -1
    lab[4:6] = -1
    res = {"tokens": tok, "labels": lab}
    for mb in (1, 2):
        model = build_model(base.replace(microbatches=mb))
        tr = DFLTrainer(model, mesh, DFLConfig(gossip_mode="tree_allreduce", lr=lr, warmup=0))
        state = tr.init_state(jax.random.PRNGKey(0))
        if mb == 1:
            save_pytree(f"{out_dir}/init_params", jax.device_get(state.params))
        batch = Batch(tokens=jnp.asarray(tok), labels=jnp.asarray(lab))
        step = tr.jitted_train_step(jax.eval_shape(lambda: state), jax.eval_shape(lambda: batch))
        state, m = step(state, batch)
        res[f"mb{mb}/loss"] = float(m["loss"])
        res[f"mb{mb}/grad_norm"] = float(m["grad_norm"])
        save_pytree(f"{out_dir}/mb{mb}_m", jax.device_get(state.opt_state["m"]))
    np.savez(f"{out_dir}/ref.npz", **{k: np.asarray(v) for k, v in res.items()})
""")


@pytest.fixture(scope="module")
def jax_p4(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_p4")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", JAX_P4, str(out)], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out, dict(np.load(out / "ref.npz"))


@pytest.mark.parametrize("mb", (1, 2))
def test_uneven_label_counts_weigh_nodes_as_the_reference_p4(jax_p4, mb):
    """P4: with the nodes' counts of labels >= 0 uneven (one node has none),
    one step's loss, grad norm and first moment (0.1 x the clipped
    gradient) match the JAX DFLTrainer's, with one microbatch and with two
    (whose slices of the global batch each span two nodes); the tolerances
    of test_one_step_matches_jax_trainer."""
    out, ref = jax_p4
    cfg, _ = _smoke()
    model = build_model(cfg.replace(microbatches=mb), device="cpu")
    like = _like(model)
    init = restore_pytree(str(out / "init_params.npz"), like)
    trainer = DFLTrainer(model, N, DFLConfig(gossip_mode="tree_allreduce", lr=LR, warmup=0),
                         device="cpu")
    opt = trainer.opt.init(init)
    state = train_state_from_numpy(
        tree_map(lambda t: t.numpy(), init), tree_map(lambda t: t.numpy(), opt), 0, N,
        device="cpu")
    batch = Batch(tokens=torch.from_numpy(ref["tokens"]).long(),
                  labels=torch.from_numpy(ref["labels"]).long())
    assert int((batch.labels[4:6] >= 0).sum()) == 0  # node 2 holds no valid label
    state, m = trainer.train_step(state, batch)
    want = ref[f"mb{mb}/loss"]
    assert abs(float(m["loss"]) - want) <= 1e-5 * abs(want)
    want = ref[f"mb{mb}/grad_norm"]
    assert abs(float(m["grad_norm"]) - want) <= 1e-4 * want
    jax_m = restore_pytree(str(out / f"mb{mb}_m.npz"), like)
    for (name, got), (_, w) in zip(_leaves(state.opt_state["m"]), _leaves(jax_m)):
        assert float((got - w).abs().max()) <= 1e-4 * float(w.abs().max()), name


def test_row_weights_follow_the_reference_slices_p4():
    """Each row's weight is 1 / (mb max(C_j, 1)) for the microbatch slice j
    of the global batch that holds it, and no part of a node's rows
    straddles two slices."""
    cfg, _ = _smoke()
    labels = torch.full((8, 5), 3)
    labels[0:2, 2:] = -1  # rows hold 2, 2, 5, 5, 0, 0, 5, 5 valid labels
    labels[4:6] = -1
    for mb, want in ((1, [1 / 24] * 8), (2, [1 / 28] * 4 + [1 / 20] * 4),
                     (4, [1 / 16] * 2 + [1 / 40] * 2 + [1 / 4] * 2 + [1 / 40] * 2),
                     (3, [1 / 24] * 8)):  # 3 does not divide 8 rows: one slice
        trainer = DFLTrainer(build_model(cfg.replace(microbatches=mb), device="cpu"), N,
                             device="cpu")
        assert torch.allclose(trainer.row_weights(labels), torch.tensor(want), rtol=1e-6,
                              atol=0), mb
        size = 8 // trainer._slices(8)
        for i in range(N):
            parts = trainer._node_parts(i, 2, 8)
            assert parts[0].start == 2 * i and parts[-1].stop == 2 * i + 2
            assert all(a.stop == b.start for a, b in zip(parts[:-1], parts[1:]))
            for p in parts:
                assert len({r // size for r in range(p.start, p.stop)}) == 1, (mb, i, p)
    # 2-row nodes: 4 slices of 2 rows coincide with the nodes, 2 give each node
    # its own 2 microbatches, 8 cut every row apart
    for mb, want in ((4, [slice(2, 4)]), (2, [slice(2, 3), slice(3, 4)]),
                     (8, [slice(2, 3), slice(3, 4)])):
        trainer = DFLTrainer(build_model(cfg.replace(microbatches=mb), device="cpu"), N,
                             device="cpu")
        assert trainer._node_parts(1, 2, 8) == want, mb


# -- the moe family: the reference's aux loss over the global batch (P4) -------------

JAX_MOE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.checkpoint import save_pytree
    from repro.configs import get_arch
    from repro.data import DataConfig, FederatedData
    from repro.dfl import DFLConfig, DFLTrainer
    from repro.models import Batch, build_model

    out_dir, n, bpn, s, lr = sys.argv[1], 4, 2, 32, 1e-3
    mesh = jax.make_mesh((n, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    res = {}
    for run, arch, mb in MOE_RUNS:
        base = get_arch(arch).smoke_variant()
        model = build_model(base.replace(microbatches=mb))
        tok, lab = FederatedData(DataConfig(vocab=base.vocab, seq_len=s, batch_per_node=bpn,
                                            n_nodes=n, seed=5)).global_batch()
        res[f"{run}/tokens"], res[f"{run}/labels"] = tok, lab
        # the stubbed frontends' inputs, one draw a row
        g, frontend = np.random.default_rng(6), {}
        if base.family == "audio":
            frontend["encoder_frames"] = g.standard_normal(
                (n * bpn, base.n_frames, base.d_model), dtype=np.float32)
        if base.family == "vlm":
            frontend["patch_embeddings"] = g.standard_normal(
                (n * bpn, base.n_patches, base.d_model), dtype=np.float32)
        for k, v in frontend.items():
            res[f"{run}/{k}"] = v
        tr = DFLTrainer(model, mesh, DFLConfig(gossip_mode="tree_allreduce", lr=lr, warmup=0))
        state = tr.init_state(jax.random.PRNGKey(0))
        init = jax.device_get(state.params)
        save_pytree(f"{out_dir}/{run}_init", init)
        batch = Batch(tokens=jnp.asarray(tok), labels=jnp.asarray(lab),
                      **{k: jnp.asarray(v) for k, v in frontend.items()})
        step = tr.jitted_train_step(jax.eval_shape(lambda: state), jax.eval_shape(lambda: batch))
        state, m = step(state, batch)
        res[f"{run}/loss"] = float(m["loss"])
        res[f"{run}/grad_norm"] = float(m["grad_norm"])
        save_pytree(f"{out_dir}/{run}_params", jax.device_get(state.params))
        save_pytree(f"{out_dir}/{run}_opt", jax.device_get(state.opt_state))
        if base.family == "moe" and mb == 1:  # the global batch's aux against the nodes' own
            fwd = jax.jit(model.forward)
            res[f"{run}/aux_global"] = float(fwd(init, Batch(tokens=jnp.asarray(tok)))[1])
            res[f"{run}/aux_node_mean"] = float(np.mean([float(fwd(init, Batch(
                tokens=jnp.asarray(tok[i * bpn:(i + 1) * bpn])))[1]) for i in range(n)]))
    np.savez(f"{out_dir}/ref.npz", **{k: np.asarray(v) for k, v in res.items()})
""")
MOE_RUNS = (("qwen3_mb1", "qwen3-moe-30b-a3b", 1), ("qwen3_mb2", "qwen3-moe-30b-a3b", 2),
            ("arctic", "arctic-480b", 8))


HYBRID_RUNS = (("zamba2", "zamba2-7b", 1),)
FRONTEND_RUNS = (("whisper_mb1", "whisper-tiny", 1), ("whisper_mb2", "whisper-tiny", 2),
                 ("paligemma_mb1", "paligemma-3b", 1), ("paligemma_mb2", "paligemma-3b", 2))


def _jax_steps(out, runs):
    """One JAX ``DFLTrainer`` step of each run (the ``JAX_MOE`` script) into
    ``out``; returns its ref.npz."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    script = JAX_MOE.replace("MOE_RUNS", repr(runs))
    proc = subprocess.run([sys.executable, "-c", script, str(out)], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out / "ref.npz"))


@pytest.fixture(scope="module")
def jax_moe(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_moe")
    ref = _jax_steps(out, MOE_RUNS)
    # the reference's aux over the global batch is not the mean of the nodes'
    # own, by more than the loss tolerance: a trainer that took each node's
    # own aux could not pass
    gap = MOE_AUX_WEIGHT * abs(float(ref["qwen3_mb1/aux_global"])
                               - float(ref["qwen3_mb1/aux_node_mean"]))
    assert gap > 1e-5 * abs(float(ref["qwen3_mb1/loss"])), gap
    return out, ref


@pytest.fixture(scope="module")
def jax_hybrid(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_hybrid")
    return out, _jax_steps(out, HYBRID_RUNS)


@pytest.fixture(scope="module")
def jax_frontend(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_frontend")
    return out, _jax_steps(out, FRONTEND_RUNS)


@pytest.mark.parametrize("run,arch,mb", MOE_RUNS, ids=[r[0] for r in MOE_RUNS])
def test_moe_step_matches_jax_trainer_with_the_global_aux_p4(jax_moe, run, arch, mb):
    m = _step_against_jax(*jax_moe, run, arch, mb)
    assert float(m["route_mismatch"]) == 0.0


@pytest.mark.parametrize("run,arch,mb", HYBRID_RUNS, ids=[r[0] for r in HYBRID_RUNS])
def test_hybrid_step_matches_jax_trainer(jax_hybrid, run, arch, mb):
    m = _step_against_jax(*jax_hybrid, run, arch, mb)
    assert "route_mismatch" not in m


@pytest.mark.parametrize("run,arch,mb", FRONTEND_RUNS, ids=[r[0] for r in FRONTEND_RUNS])
def test_frontend_step_matches_jax_trainer(jax_frontend, run, arch, mb):
    """whisper's frames and paligemma's patches go to each node with its
    token rows (and to each microbatch with its part): one step against the
    JAX ``DFLTrainer``'s, as the module docstring says."""
    out, ref = jax_frontend
    key = "encoder_frames" if arch == "whisper-tiny" else "patch_embeddings"
    rows = ref[f"{run}/{key}"]
    assert rows.shape[0] == N * BPN and np.abs(rows[0] - rows[BPN]).max() > 1.0
    m = _step_against_jax(out, ref, run, arch, mb)
    assert "route_mismatch" not in m


def _step_against_jax(out, ref, run, arch, mb):
    """One port step of ``run`` against the reference's (loss within 1e-5
    relative, grad norm within 1e-4 relative, the moments and params as the
    module docstring says); returns the step's metrics."""
    cfg = get_arch(arch).smoke_variant().replace(microbatches=mb)
    model = build_model(cfg, device="cpu")
    like = _like(model)
    init = restore_pytree(str(out / f"{run}_init.npz"), like)
    trainer = DFLTrainer(model, N, DFLConfig(gossip_mode="tree_allreduce", lr=LR, warmup=0),
                         device="cpu")
    opt = trainer.opt.init(init)
    state = train_state_from_numpy(
        tree_map(lambda t: t.numpy(), init), tree_map(lambda t: t.numpy(), opt), 0, N,
        device="cpu")
    frontend = {k: torch.from_numpy(ref[f"{run}/{k}"]) for k in ("encoder_frames",
                                                                  "patch_embeddings")
                if f"{run}/{k}" in ref}
    batch = Batch(tokens=torch.from_numpy(ref[f"{run}/tokens"]).long(),
                  labels=torch.from_numpy(ref[f"{run}/labels"]).long(), **frontend)
    state, m = trainer.train_step(state, batch)
    want = ref[f"{run}/loss"]
    assert abs(float(m["loss"]) - want) <= 1e-5 * abs(want), (float(m["loss"]), want)
    want = ref[f"{run}/grad_norm"]
    assert abs(float(m["grad_norm"]) - want) <= 1e-4 * want, (float(m["grad_norm"]), want)
    want_opt = restore_pytree(str(out / f"{run}_opt.npz"), opt)
    moment = "m" if "m" in opt else "f"  # Adafactor keeps no first moment
    _close_per_leaf(state.opt_state[moment], want_opt[moment], 1e-4)
    want_p = restore_pytree(str(out / f"{run}_params.npz"), like)
    for node in range(N):
        got_p = tree_map(lambda t: t[node], state.params)
        if moment == "f":
            _close_per_leaf(got_p, want_p, 1e-4)
            continue
        # Adam's first step moves an element by lr g / (|g| + eps): where g is
        # near 0 a sum order moves that by a share of lr (the bound of
        # test_one_step_matches_jax_trainer)
        for (name, g), (_, w) in zip(_leaves(got_p), _leaves(want_p)):
            assert float((g - w).abs().max()) <= 0.1 * LR, f"{name} node {node}"
    return m


# -- the port alone ---------------------------------------------------------------

def _data_batch(cfg, seq=S, seed=0):
    tok, lab = FederatedData(DataConfig(vocab=cfg.vocab, seq_len=seq, batch_per_node=BPN,
                                        n_nodes=N, seed=seed)).global_batch()
    return Batch(tokens=torch.from_numpy(tok).long(), labels=torch.from_numpy(lab).long())


def test_per_node_gradients_and_their_mean_do_not_mix_nodes():
    cfg, model = _smoke()
    trainer = DFLTrainer(model, N, DFLConfig(lr=LR, warmup=0), device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    params = tree_map(lambda t: t + 0.01 * torch.randn(t.shape, generator=g), state.params)
    batch = _data_batch(cfg)
    loss, mean, node_losses, mismatch = trainer.grads(params, batch)
    assert mismatch is None  # a model without experts routes nothing
    own = []
    for i in range(N):
        rows = slice(i * BPN, (i + 1) * BPN)
        p_i = tree_map(lambda t: t[i].clone().requires_grad_(True), params)
        l_i = model.train_loss(p_i, Batch(tokens=batch.tokens[rows], labels=batch.labels[rows]))
        own.append(torch.autograd.grad(l_i, tree_leaves(p_i)))
        assert abs(node_losses[i] - float(l_i)) <= 1e-6 * abs(float(l_i))
    want = [sum(gs) / N for gs in zip(*own)]
    for got, w in zip(tree_leaves(mean), want):
        assert float((got - w).abs().max()) <= 1e-6 * float(w.abs().max())
    assert abs(float(loss) - sum(node_losses) / N) <= 1e-6
    # a node's rows and params reach its gradient alone
    assert max(float((a - b).abs().max()) for a, b in zip(own[0], own[1])) > 0


@pytest.mark.parametrize("make", [
    lambda: adafactor(constant_schedule(1e-2), weight_decay=0.1),
    lambda: adamw(constant_schedule(1e-2)),
    lambda: adamw(constant_schedule(1e-2), master_fp32=False, moment_dtype=torch.bfloat16),
], ids=["adafactor", "adamw", "adamw-bf16-moments-no-master"])
def test_stacked_update_equals_per_node_updates(make):
    """A leaf-shaped gradient and moment against (N, ...) params: each node's
    row updates as it would alone (Adafactor's rms_u over the logical leaf,
    never over the node axis)."""
    opt = make()
    g = torch.Generator().manual_seed(0)
    shapes = {"w": (6, 5), "t": (3, 4, 5), "b": (7,)}
    single = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    stacked = {k: torch.stack([v + 0.1 * i for i in range(N)]) for k, v in single.items()}
    grads = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    state = opt.init(single)
    if "master" in state:
        state["master"] = {k: v.clone() for k, v in stacked.items()}
    new_p, new_s = opt.update(stacked, grads, state, torch.tensor(3))
    for i in range(N):
        st_i = opt.init(single)
        if "master" in st_i:
            st_i["master"] = {k: v[i].clone() for k, v in stacked.items()}
        p_i, s_i = opt.update({k: v[i] for k, v in stacked.items()}, grads, st_i,
                              torch.tensor(3))
        for k in shapes:
            assert torch.equal(new_p[k][i], p_i[k]), k
            if "master" in s_i:
                assert torch.equal(new_s["master"][k][i], s_i["master"][k]), k
    for k in ("m", "v", "f"):
        if k in new_s:
            for leaf in tree_leaves(new_s[k]):
                assert leaf.dim() <= 3  # leaf-shaped: no node axis


def test_microbatches_match_one_batch():
    cfg, _ = _smoke()
    batch = _data_batch(cfg)
    out = []
    for mb in (1, 2):
        model = build_model(cfg.replace(microbatches=mb), device="cpu")
        trainer = DFLTrainer(model, N, DFLConfig(lr=LR, warmup=0), device="cpu")
        state = trainer.init_state(torch.Generator().manual_seed(0))
        out.append(trainer.grads(state.params, batch))
    # each microbatch's mean CE over its own positions: equal counts, so the
    # average of the two is the whole rows' mean
    assert abs(float(out[0][0]) - float(out[1][0])) <= 1e-5 * abs(float(out[0][0]))
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


def test_gossip_modes_agree_after_one_step():
    """dissemination + FedAvg, tree all-reduce and flooding: the same params
    within 1e-5 after one step (granite smoke, tests/test_system.py's bound)."""
    cfg = get_arch("granite-3-2b").smoke_variant()
    model = build_model(cfg, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (8, 32))).long()
    batch = Batch(tokens=tok, labels=tok)
    flat = {}
    for mode in ("dissemination", "tree_allreduce", "flooding"):
        trainer = DFLTrainer(model, N, DFLConfig(gossip_mode=mode, lr=1e-3, warmup=0),
                             device="cpu")
        state, _ = trainer.train_step(trainer.init_state(torch.Generator().manual_seed(0)),
                                      batch)
        flat[mode] = torch.cat([t.float().reshape(-1) for t in tree_leaves(state.params)])
    assert float((flat["dissemination"] - flat["tree_allreduce"]).abs().max()) < 1e-5
    assert float((flat["dissemination"] - flat["flooding"]).abs().max()) < 1e-5


@pytest.mark.parametrize("mode,codec", [("tree_allreduce", ""), ("dissemination", "topk")])
def test_loss_falls_over_14_steps(mode, codec):
    """tree all-reduce (tests/test_system.py) and error-feedback top-k
    (tests/test_codec.py): the loss falls over 14 steps on fresh batches;
    with top-k the residual is carried in opt_state["codec_ef"]."""
    cfg, model = _smoke()
    trainer = DFLTrainer(model, N, DFLConfig(gossip_mode=mode, codec=codec, lr=2e-3),
                         device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    assert ("codec_ef" in state.opt_state) == (codec == "topk")
    data = FederatedData(DataConfig(vocab=cfg.vocab, seq_len=64, batch_per_node=BPN,
                                    n_nodes=N))
    losses = []
    for _ in range(14):
        tok, lab = data.global_batch()
        state, m = trainer.train_step(state, Batch(tokens=torch.from_numpy(tok).long(),
                                                   labels=torch.from_numpy(lab).long()))
        losses.append(float(m["loss"]))
    assert min(losses[-3:]) < losses[0], losses
    if codec == "topk":
        ef = tree_leaves(state.opt_state["codec_ef"])
        assert all(t.shape[0] == N and t.dtype == torch.float32 for t in ef)
        assert any(float(t.abs().max()) > 0 for t in ef)


def test_dfl_config_matches_jax():
    from repro.dfl import DFLConfig as JaxDFLConfig

    assert dataclasses.asdict(DFLConfig()) == dataclasses.asdict(JaxDFLConfig())


def test_remat_gives_the_same_gradients():
    """cfg.remat runs each layer under torch.utils.checkpoint (the forward
    again in the backward), as jax.checkpoint does there: same gradients."""
    _remat_grads_agree(_smoke()[0])


def test_remat_gives_the_same_gradients_for_the_hybrid():
    """The hybrid checkpoints each super-block (its Mamba2 blocks and the
    shared attention block) and each tail block, as the JAX package's
    remat wraps its scan bodies: same gradients, the shared block's sum
    over its two uses included."""
    _remat_grads_agree(get_arch("zamba2-7b").smoke_variant().replace(n_layers=5, attn_every=2))


def _remat_grads_agree(cfg):
    batch = _data_batch(cfg)
    out = []
    for remat in (False, True):
        model = build_model(cfg.replace(remat=remat), device="cpu")
        trainer = DFLTrainer(model, N, DFLConfig(lr=LR, warmup=0), device="cpu")
        out.append(trainer.grads(trainer.init_state(torch.Generator().manual_seed(0)).params,
                                 batch))
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())


def test_donated_step_consumes_its_input_state_and_steps_alike():
    """A step donates its input state (the reference's donate_argnums=(0,)):
    the input state's params and opt_state are dropped, and two steps from
    equal states give equal results."""
    cfg, model = _smoke()
    batch = _data_batch(cfg)
    trainer = DFLTrainer(model, N, DFLConfig(gossip_mode="dissemination", codec="int8",
                                             lr=LR, warmup=0), device="cpu")
    first = trainer.init_state(torch.Generator().manual_seed(0))
    second = TrainState(params=tree_map(torch.clone, first.params),
                        opt_state=tree_map(torch.clone, first.opt_state),
                        step=first.step.clone())
    out = []
    for state in (first, second):
        new, m = trainer.train_step(state, batch)
        assert state.params is None and state.opt_state is None
        out.append((new, float(m["loss"])))
    assert out[0][1] == out[1][1]
    for a, b in zip(tree_leaves(out[0][0].params), tree_leaves(out[1][0].params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(out[0][0].opt_state), tree_leaves(out[1][0].opt_state)):
        assert torch.equal(a, b)


def test_train_state_crosses_to_jax_numpy_and_back():
    from repro_torch.convert import train_state_to_numpy

    cfg, model = _smoke()
    trainer = DFLTrainer(model, N, DFLConfig(gossip_mode="dissemination", codec="topk", lr=LR,
                                             warmup=0), device="cpu")
    state, _ = trainer.train_step(trainer.init_state(torch.Generator().manual_seed(0)),
                                  _data_batch(cfg))
    params, opt, step = train_state_to_numpy(state, node=2)
    assert step == 1 and sorted(opt) == ["codec_ef", "m", "master", "v"]
    back = train_state_from_numpy(params, opt, step, N, device="cpu")
    for tree, want in ((back.params, state.params), (back.opt_state["codec_ef"],
                                                     state.opt_state["codec_ef"])):
        for got, w in zip(tree_leaves(tree), tree_leaves(want)):
            assert got.shape == w.shape and all(torch.equal(got[i], w[2]) for i in range(N))
    for got, w in zip(tree_leaves(back.opt_state["m"]), tree_leaves(state.opt_state["m"])):
        assert torch.equal(got, w)
