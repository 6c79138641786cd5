"""The port's DFL training step against the JAX package's, on the CPU.

* ``Model.train_loss`` gradients against ``jax.grad`` of the JAX model on the
  same params (converted leaf for leaf) and tokens, for the f32 smoke
  variants of smollm-360m, granite-3-2b, gemma2-2b (s above its window) and
  falcon-mamba-7b: within 1e-4 of each leaf's max |g| (attention, scan and
  matmuls sum in another order than XLA).
* One DFL step of the port on 4 stacked nodes against the JAX ``DFLTrainer``
  on 4 forced host devices with an Auto-axis mesh (ROADMAP R1), from the
  same init and batch: loss within 1e-5 relative, grad_norm within 1e-4
  relative, every node's params and masters within 0.1 lr of the
  reference's (Adam's first step moves an element by lr g / |g|, so a
  gradient near 0 can move it by a fraction of lr either way). The
  ``gossip_interval=2`` path likewise over two steps.
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
from repro_torch.dfl.trainer import DFLConfig, DFLTrainer  # noqa: E402
from repro_torch.models import Batch, build_model  # noqa: E402
from repro_torch.optim import adafactor, adamw, constant_schedule  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("smollm-360m", "granite-3-2b", "gemma2-2b", "falcon-mamba-7b")
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
    _, g0 = trainer.node_grads(init, batch.tokens[:BPN], batch.labels[:BPN])
    _, g1 = trainer.node_grads(init, batch.tokens[BPN:2 * BPN], batch.labels[BPN:2 * BPN])
    diff = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))
    assert abs(diff - ref["r9/node_grad_diff"]) <= 1e-3 * ref["r9/node_grad_diff"]


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
    loss, mean, node_losses = trainer.grads(params, batch)
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
    cfg, _ = _smoke()
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
