"""The multi-rank DFL trainer of the port on four gloo ranks on the CPU:
gossip between ranks (``GossipPlan.build_mesh``), the meshed trainer
(``dfl/trainer.py::MeshDFLTrainer``) and ``launch/train.py --mesh``.

One spawned group of four processes (a ``FileStore`` under ``tmp_path``)
runs every case, as ``tests/test_torch_mesh_serve.py`` does, and is joined
with a timeout (``TIMEOUT_S``); each rank writes what it measured, and the
tests below read it. Two meshes: (4, 1) ("data", "model"), four nodes of one
rank, and (2, 2), two nodes of two "model" shards; the gossip also on
(2, 2, 1) ("pod", "data", "model"), four nodes over two node axes in two
pods (the plan prices the links between pods; flooding and
``allreduce_ref`` run over the two axes flattened).

(a) The gossip backend alone: a tree of four leaves (f32 and bf16, one
    split on "model" on the (2, 2) mesh, sizes that leave a padded chunk
    and top-k block) from seeded per-node values. Each rank's output is
    bit-identical to the stacked ``gossip_exchange`` row of its node, cut
    to its shard: every mode, the int8 / int4 / top-k wires (bf16 on the
    tree), error feedback, and a churn plan (node 1 masked out, four nodes).
    ``allreduce_ref`` at four nodes sums in gloo's order, so it is held to
    f32 rounding there (two nodes: bit-identical). The point-to-point bytes
    a rank reports to the op counter (kind ``collective-permute``) equal
    ``rank_gossip_bytes``, and over
    the nodes a raw wire's equal ``gossip_collective_bytes`` (of each leaf
    padded to whole segments for segmented gossip). The
    stacked path of the exact modes equals the FedAvg mean to f32 rounding.
(b) Two trainer steps of the smoke smollm-360m (tree all-reduce and int8
    dissemination; 8 rows of 32 tokens a step), of a
    smoke qwen3-moe-30b-a3b and of arctic-480b's (8 microbatches, Adafactor
    on the DTensors; one node on both meshes: their node axes are "pod"; no
    dropped tokens, capacity factor 100) against the stacked port
    trainer on the same init and batches: the loss and grad norm within 1e-6
    relative (the gradient all-reduce sums in another order), the masters
    within 0.1 lr (Adam's step moves an element by about lr g / |g|, so a
    gradient near 0 summed in another order moves it by a fraction of lr;
    1e-6 of max |theta| does not hold for Adam), and the Adam moments equal
    on every node's ranks (R9). int8 dissemination after its first round:
    the masters within 0.1 lr plus twice the codec's bound (on (2, 2) a rank
    encodes its own shard's chunks, as the reference's ``shard_map`` does,
    where the stacked trainer encodes whole leaves), and the second step's
    loss within 1e-4 and grad norm within 1e-3 relative.
(c) One step on the (2, 2) mesh against the JAX ``DFLTrainer`` on a (2, 2)
    Auto-axis mesh of 4 forced host devices (R1), run in a subprocess as
    ``tests/test_torch_trainer.py`` runs it, within that file's tolerances:
    loss 1e-5 and grad norm 1e-4 relative, params and masters 0.1 lr.
(d) ``launch/train.py --mesh 2x2 --device cpu --smoke --steps 2`` on the four
    ranks prints the reference launcher's lines from rank 0 and writes one
    checkpoint a node (its parameters gathered over "model"); ``--nodes``
    with ``--mesh`` and a mesh larger than the group fail by name.
(e) The meshed loss and gradients (``MeshDFLTrainer.mesh_grads``) of the
    smoke dense (smollm-360m; gemma2-2b with its final softcap and
    alternating windows), ssm (falcon-mamba-7b) and moe (qwen3-moe-30b-a3b)
    models on (2, 2) and (1, 4) meshes, with the sequence split over "model"
    between sublayers (ROADMAP P10: gathered and reduce-scattered by
    ``models/layers.py::_SeqGather`` / ``_SeqScatter``) and the logits kept
    split by vocabulary into the vocab-parallel cross-entropy (P9,
    ``_VocabParallelCE``), against ``train_loss`` of the unsharded port on
    the same params and global batch: the loss within 1e-6 relative and the
    gradient's global norm, and the norm of its difference, within 1e-6 of
    that norm (as (b)'s grad norm); each of the three Functions must run.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.multiprocessing as mp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT_S = 300
MESHES = {"4x1": (4, 1), "2x2": (2, 2)}
# (a) also on a three-axis mesh: 4 nodes over ("pod", "data"), 2 pods
GOSSIP_MESHES = {**MESHES, "2x2x1": (2, 2, 1)}
MODES = ("dissemination", "segmented", "tree_allreduce", "mixing", "flooding", "allreduce_ref")
CODECS = ("int8", "int4", "topk")
CODEC_MODES = ("dissemination", "segmented", "tree_allreduce", "flooding")
LR = 1e-3

# (a)'s cases: (name, mode, codec, wire dtype, ef, churn)
CASES = ([(m, m, "", "", False, False) for m in MODES]
         + [(f"{m}-{c}", m, c, "", False, False) for m in CODEC_MODES for c in CODECS]
         + [("tree_allreduce-bf16wire", "tree_allreduce", "", "bfloat16", False, False),
            ("dissemination-topk-ef", "dissemination", "topk", "", True, False),
            ("dissemination-int8-ef", "dissemination", "int8", "", True, False)]
         + [(f"{m}-churn", m, "", "", False, True) for m in MODES]
         + [("dissemination-int8-churn", "dissemination", "int8", "", False, True)])
# (e)'s gradient cases: meshes and archs
GRAD_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
GRAD_ARCHS = ("smollm-360m", "gemma2-2b", "falcon-mamba-7b", "qwen3-moe-30b-a3b")
# (b)'s trainer runs: (arch, gossip mode, codec)
TRAINER_CASES = (("smollm-360m", "tree_allreduce", ""), ("smollm-360m", "dissemination", "int8"),
                 ("qwen3-moe-30b-a3b", "tree_allreduce", ""), ("arctic-480b", "tree_allreduce", ""))
# the stacked modes whose round is the FedAvg mean up to f32 rounding
EXACT = ("dissemination", "segmented", "tree_allreduce", "flooding", "allreduce_ref")

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

    out_dir, lr = sys.argv[1], 1e-3
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    cfg = get_arch("smollm-360m").smoke_variant()
    model = build_model(cfg)
    data = FederatedData(DataConfig(vocab=cfg.vocab, seq_len=32, batch_per_node=4, n_nodes=2))
    tok, lab = data.global_batch()
    tr = DFLTrainer(model, mesh, DFLConfig(gossip_mode="tree_allreduce", lr=lr, warmup=0))
    state = tr.init_state(jax.random.PRNGKey(0))
    save_pytree(f"{out_dir}/init_params", jax.device_get(state.params))
    batch = Batch(tokens=jnp.asarray(tok), labels=jnp.asarray(lab))
    step = tr.jitted_train_step(jax.eval_shape(lambda: state), jax.eval_shape(lambda: batch))
    state, m = step(state, batch)
    save_pytree(f"{out_dir}/params", jax.device_get(state.params))
    save_pytree(f"{out_dir}/master", jax.device_get(state.opt_state["master"]))
    np.savez(f"{out_dir}/ref.npz", tokens=tok, labels=lab, loss=float(m["loss"]),
             grad_norm=float(m["grad_norm"]))
""")


# -- (a) the gossip backend ---------------------------------------------------------------

def _node_values(n):
    """Seeded per-node leaves, stacked (n, ...)."""
    g = np.random.default_rng(7)
    return {
        "w": torch.from_numpy(g.standard_normal((n, 8, 6)).astype(np.float32)),
        "e": torch.from_numpy(g.standard_normal((n, 1300)).astype(np.float32)),
        "b": torch.from_numpy(g.standard_normal((n, 5)).astype(np.float32)),
        "h": torch.from_numpy(g.standard_normal((n, 4, 6)).astype(np.float32)).bfloat16(),
    }


def _shard(t, mesh, spec):
    """Rank's shard of whole ``t`` by a (dim -> "model") spec."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dfl.sharding import placements

    return distribute_tensor(t, mesh, placements(mesh, spec), src_data_rank=None).to_local()


def _gossip_cases(mesh):
    from repro_torch.compress import make_codec
    from repro_torch.dfl.collectives import (P2P_KIND, GossipPlan, gossip_collective_bytes,
                                             gossip_exchange, rank_gossip_bytes)
    from repro_torch.dfl.session import plan_for_members
    from repro_torch.dfl.sharding import Spec
    from repro_torch.launch.op_analysis import OpCounter

    specs = {"w": Spec(None, "model"), "e": Spec("model"), "b": Spec(), "h": Spec()}
    mplan = GossipPlan.build_mesh(mesh, ("pod", "data"))
    n, me = mplan.n_nodes, mplan.nodes.node
    stacked = _node_values(n)
    ef_stacked = {k: torch.from_numpy(np.random.default_rng(11).standard_normal(
        tuple(v.shape)).astype(np.float32) * 0.01) for k, v in stacked.items()}
    out = {}
    for name, mode, codec_name, wire, ef, churn in CASES:
        if churn and n < 4:
            continue
        codec = make_codec(codec_name) if codec_name else None
        wdt = torch.bfloat16 if wire else None
        pods = mplan.nodes.n_pods
        splan = GossipPlan.build(n, n_pods=pods)
        plan = mplan
        if churn:
            splan = plan_for_members(n, {0, 2, 3}, n_pods=pods)
            plan = plan_for_members(n, {0, 2, 3}, n_pods=pods)
            plan.nodes = mplan.nodes
        # every node's shard at this rank's coordinates, stacked (n, ...)
        shards = {k: torch.stack([_shard(v[i], mesh, specs[k]) for i in range(n)])
                  for k, v in stacked.items()}
        ef_shards = {k: torch.stack([_shard(v[i], mesh, specs[k]) for i in range(n)])
                     for k, v in ef_stacked.items()}
        local = {k: v[me] for k, v in shards.items()}
        kw = dict(wire_dtype=wdt, codec=codec)
        if ef:
            kw = dict(codec=codec)
            want, want_ef = gossip_exchange(mode, splan, shards, ef_state=ef_shards, **kw)
            with OpCounter() as c:
                got, got_ef = gossip_exchange(mode, plan, local, ef_state={
                    k: v[me] for k, v in ef_shards.items()}, **kw)
        else:
            want = gossip_exchange(mode, splan, shards, **kw)
            with OpCounter() as c:
                got = gossip_exchange(mode, plan, local, **kw)
        if not codec_name and not ef:  # a whole leaf's row, cut to the shard, is the same
            whole = gossip_exchange(mode, splan, stacked, **kw)
            assert all(torch.equal(_shard(whole[k][me], mesh, specs[k]), want[k][me])
                       for k in stacked), name
        equal, err = True, 0.0
        pairs = [(got[k], want[k][me]) for k in stacked]
        if ef:
            pairs += [(got_ef[k], want_ef[k][me]) for k in stacked]
        for g, w in pairs:
            equal &= bool(torch.equal(g, w)) and g.dtype == w.dtype and g.shape == w.shape
            err = max(err, float((g.float() - w.float()).abs().max()
                                 / w.float().abs().max().clamp(min=1e-30)))
        counted = float(c.stats.collective_bytes.get(P2P_KIND, 0.0))
        predicted = rank_gossip_bytes(mode, plan, local, wire_dtype=wdt, codec=codec)
        total = None
        if not codec_name and not wire and not churn and mode not in ("flooding",
                                                                       "allreduce_ref"):
            # one node's shards in f32; a segmented round pads each leaf to
            # whole segments
            S = plan.n_segments if mode == "segmented" else 1
            shard_f32 = sum(-(-v.numel() // S) * S * 4 for v in local.values())
            per_node = [rank_gossip_bytes(mode, plan, {k: v.float() for k, v in local.items()},
                                          node=i) for i in range(n)]
            total = (sum(per_node), gossip_collective_bytes(mode, splan, shard_f32))
        exact = None
        if mode in EXACT and not codec_name and not wire and not churn and me == 0:
            mean = {k: v.float().mean(dim=0) for k, v in stacked.items()}
            whole = gossip_exchange(mode, splan, stacked)
            exact = max(float((whole[k][i].float() - mean[k]).abs().max()
                              / mean[k].abs().max()) for k in ("w", "e", "b") for i in range(n))
        out[name] = dict(equal=equal, err=err, counted=counted, predicted=predicted,
                         p2p_calls=int(c.stats.collectives.get(P2P_KIND, 0)), total=total,
                         exact=exact, nodes=n, collectives=dict(c.stats.collectives))
    return out


# -- (b) two trainer steps against the stacked trainer -----------------------------------

def _cfg(arch):
    from repro_torch.configs import get_arch

    cfg = get_arch(arch).smoke_variant()
    if cfg.family == "moe":
        cfg = cfg.replace(moe_capacity_factor=100.0)
    return cfg


def _batches(cfg, rows, n=2):
    g = np.random.default_rng(5)
    out = []
    for _ in range(n):
        tok = g.integers(0, cfg.vocab, (rows, 32))
        lab = g.integers(0, cfg.vocab, (rows, 32))
        lab[0, :3] = -1
        out.append((tok, lab))
    return out


def _master_gap(meshed, ms, ss):
    """The largest |meshed - stacked| master (or parameter) element of this
    rank's node, and the largest |theta| of the stacked one."""
    from repro_torch.dfl.collectives import tree_flatten

    me = meshed.plan.nodes.node
    got = tree_flatten(ms.opt_state.get("master", ms.params))[0]
    want = tree_flatten(ss.opt_state.get("master", ss.params))[0]
    gap = scale = 0.0
    for dm, st in zip(got, want):
        full = dm.full_tensor().float()  # this node's leaf, gathered over "model"
        gap = max(gap, float((full - st[me].float()).abs().max()))
        scale = max(scale, float(st[me].float().abs().max()))
    return gap, scale


def _trainer_case(mesh, arch, mode, codec):
    import torch.distributed as dist

    from repro_torch.compress import make_codec
    from repro_torch.dfl.collectives import tree_flatten
    from repro_torch.dfl.trainer import DFLConfig, DFLTrainer, MeshDFLTrainer
    from repro_torch.models import Batch, build_model

    cfg = _cfg(arch)
    model = build_model(cfg, device="cpu")
    dfl = DFLConfig(gossip_mode=mode, codec=codec, lr=LR, warmup=0)
    meshed = MeshDFLTrainer(model, mesh, dfl)
    stacked = DFLTrainer(model, meshed.n_nodes, dfl, device="cpu")
    init = model.init(torch.Generator().manual_seed(0))
    ms, ss = meshed.state_from_params(init), stacked.state_from_params(init)
    res = {"nodes": meshed.n_nodes, "steps": []}
    for tok, lab in _batches(cfg, 8):
        batch = Batch(tokens=torch.from_numpy(tok), labels=torch.from_numpy(lab))
        ms, mm = meshed.train_step(ms, batch)
        ss, sm = stacked.train_step(ss, batch)
        gap, scale = _master_gap(meshed, ms, ss)
        res["steps"].append(dict(
            loss=(float(mm["loss"]), float(sm["loss"])),
            grad_norm=(float(mm["grad_norm"]), float(sm["grad_norm"])), master_gap=gap,
            codec_atol=make_codec(codec).mean_atol(scale) if codec else 0.0))
    # R9: the moments equal on every rank that holds the same shard
    spread = 0.0
    for k in ("m", "v"):
        for t in tree_flatten(ms.opt_state.get(k, {}))[0]:
            local = t.to_local().contiguous()
            got = [torch.empty_like(local) for _ in range(dist.get_world_size())]
            dist.all_gather(got, local)
            peers = meshed.plan.nodes.ranks
            spread = max(spread, max(float((got[r] - got[peers[0]]).abs().max())
                                     for r in peers))
    res["moment_spread"] = spread
    return res


# -- (c) one step against the JAX trainer --------------------------------------------------

def _jax_case(mesh, ref_dir):
    from repro_torch.checkpoint import restore_pytree
    from repro_torch.dfl.collectives import tree_map
    from repro_torch.dfl.trainer import DFLConfig, MeshDFLTrainer
    from repro_torch.models import Batch, build_model

    cfg = _cfg("smollm-360m")
    model = build_model(cfg, device="cpu")
    like = model.init(torch.Generator().manual_seed(0))
    init = restore_pytree(os.path.join(ref_dir, "init_params.npz"), like)
    ref = np.load(os.path.join(ref_dir, "ref.npz"))
    tr = MeshDFLTrainer(model, mesh, DFLConfig(gossip_mode="tree_allreduce", lr=LR, warmup=0))
    state = tr.state_from_params(init)
    batch = Batch(tokens=torch.from_numpy(ref["tokens"]).long(),
                  labels=torch.from_numpy(ref["labels"]).long())
    state, m = tr.train_step(state, batch)
    errs = {}
    for name, got in (("params", state.params), ("master", state.opt_state["master"])):
        want = restore_pytree(os.path.join(ref_dir, f"{name}.npz"), like)
        flat_g, flat_w = [], []
        tree_map(lambda a, b: (flat_g.append(a), flat_w.append(b)), got, want)
        errs[name] = max(float((g.full_tensor().float() - w.float()).abs().max())
                         for g, w in zip(flat_g, flat_w))
    return dict(loss=(float(m["loss"]), float(ref["loss"])),
                grad_norm=(float(m["grad_norm"]), float(ref["grad_norm"])), **errs)


# -- (e) the meshed loss and gradients against the unsharded port -------------------------

def _grads_case(mesh, arch):
    from collections import Counter

    from repro_torch.dfl.collectives import tree_flatten
    from repro_torch.dfl.trainer import DFLConfig, MeshDFLTrainer
    from repro_torch.models import Batch, build_model, layers

    cfg = _cfg(arch)
    model = build_model(cfg, device="cpu")
    init = model.init(torch.Generator().manual_seed(0))
    tok, lab = _batches(cfg, 8, 1)[0]
    batch = Batch(tokens=torch.from_numpy(tok), labels=torch.from_numpy(lab))
    leaves, rebuild = tree_flatten(init)
    live = [t.detach().requires_grad_(True) for t in leaves]
    want_loss = model.train_loss(rebuild(live), batch)
    want = torch.autograd.grad(want_loss, live)

    calls = Counter()
    patched = (layers._SeqGather, layers._SeqScatter, layers._VocabParallelCE)
    saved = [c.forward for c in patched]

    def counted(cls, fwd):
        def forward(ctx, *args):
            calls[cls.__name__] += 1
            return fwd(ctx, *args)
        return staticmethod(forward)

    tr = MeshDFLTrainer(model, mesh, DFLConfig(gossip_mode="tree_allreduce", lr=LR, warmup=0))
    state = tr.state_from_params(init)
    for c, f in zip(patched, saved):
        c.forward = counted(c, f)
    try:
        loss, grads, dleaves = tr.mesh_grads(state.params, batch)
    finally:
        for c, f in zip(patched, saved):
            c.forward = staticmethod(f)
    got = [torch.distributed.tensor.DTensor.from_local(g, mesh, p.placements,
                                                       run_check=False).full_tensor()
           for g, p in zip(grads, dleaves)]
    diff = sum(float((g.double() - w.double()).square().sum()) for g, w in zip(got, want))
    norm = sum(float(w.double().square().sum()) for w in want)
    gnorm = sum(float(g.double().square().sum()) for g in got)
    return dict(loss=(float(loss), float(want_loss)), norm=(gnorm ** 0.5, norm ** 0.5),
                diff=diff ** 0.5, calls=dict(calls))


# -- (d) the launcher ---------------------------------------------------------------------

def _cli_case(ckpt_dir):
    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--mesh", "2x2", "--device", "cpu", "--smoke", "--steps", "2",
                    "--seq-len", "32", "--warmup", "0", "--log-every", "1",
                    "--checkpoint-dir", ckpt_dir, "--checkpoint-every", "2"])
    errors = {}
    for argv in (["--mesh", "2x2", "--nodes", "4"], ["--mesh", "4x2"]):
        try:
            train.main(argv + ["--device", "cpu", "--smoke", "--steps", "1"])
            errors[" ".join(argv)] = "no error"
        except (SystemExit, RuntimeError, ValueError) as e:
            errors[" ".join(argv)] = str(e)
    return dict(stdout=buf.getvalue(), errors=errors)


def _worker(rank, path, out_dir, ref_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(path, WORLD), rank=rank,
                            world_size=WORLD)
    try:
        from repro_torch.launch.mesh import make_local_mesh

        res = {"gossip": {}, "trainer": {}}
        for name, shape in GOSSIP_MESHES.items():
            axes = ("pod", "data", "model")[-len(shape):]
            mesh = make_local_mesh(shape, axes, device="cpu")
            res["gossip"][name] = _gossip_cases(mesh)
            if name not in MESHES:
                continue
            for arch, mode, codec in TRAINER_CASES:
                res["trainer"][f"{name}/{arch}/{mode}{'-' + codec if codec else ''}"] = \
                    _trainer_case(mesh, arch, mode, codec)
        res["grads"] = {f"{name}/{arch}": _grads_case(make_local_mesh(shape, device="cpu"), arch)
                        for name, shape in GRAD_MESHES.items() for arch in GRAD_ARCHS}
        res["jax"] = _jax_case(make_local_mesh((2, 2), device="cpu"), ref_dir)
        res["cli"] = _cli_case(os.path.join(out_dir, "ckpt"))
        res["ckpt_dir"] = os.path.join(out_dir, "ckpt")
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mesh_trainer")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", JAX_REF, str(out)], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return str(out)


@pytest.fixture(scope="module")
def results(tmp_path_factory, jax_ref):
    import torch.distributed as dist

    tmp = tmp_path_factory.mktemp("mesh_train")
    ctx = mp.start_processes(_worker, args=(str(tmp / "store"), str(tmp), jax_ref),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.time() + TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                raise TimeoutError(f"the gloo ranks ran past {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    assert not dist.is_initialized()
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


@pytest.mark.parametrize("case", [c[0] for c in CASES])
@pytest.mark.parametrize("mesh", list(GOSSIP_MESHES))
def test_gossip_between_ranks_is_the_stacked_row(results, mesh, case):
    for rank, res in enumerate(results):
        r = res["gossip"][mesh].get(case)
        if r is None:  # churn needs more than two nodes
            assert MESHES[mesh][0] < 4
            continue
        if case.startswith("allreduce_ref") and r["nodes"] > 2:
            assert r["err"] <= 4e-7, (rank, r["err"])  # gloo's summation order
        else:
            assert r["equal"], (rank, r["err"])
        assert r["counted"] == r["predicted"], (rank, r)
        if r["total"] is not None:
            # (the analytic formula rounds through MB)
            assert r["total"][0] == pytest.approx(r["total"][1], rel=1e-12), r["total"]
        if r["exact"] is not None:
            assert r["exact"] <= 1e-6, r["exact"]
        if case.startswith(("flooding", "allreduce_ref")):
            kind = "all-gather" if case.startswith("flooding") else "all-reduce"
            assert r["collectives"].get(kind, 0) > 0, r
            assert "collective-permute" not in r["collectives"], r
        else:
            assert r["p2p_calls"] > 0 or r["predicted"] == 0, r


def _keys():
    return [f"{m}/{a}/{mode}{'-' + c if c else ''}" for m in MESHES
            for a, mode, c in TRAINER_CASES]


@pytest.mark.parametrize("key", _keys())
def test_meshed_trainer_matches_the_stacked_trainer(results, key):
    lossy = "int8" in key
    for res in results:
        r = res["trainer"][key]
        assert len(r["steps"]) == 2
        for i, step in enumerate(r["steps"]):
            (lm, ls), (gm, gs) = step["loss"], step["grad_norm"]
            # after a lossy round the nodes' masters differ by what the
            # codec rounds otherwise (a shard's chunks on (2, 2)), and the
            # second step's loss with them
            tol = 1e-6 if i == 0 or not lossy else 1e-4
            assert abs(lm - ls) <= tol * abs(ls), step
            assert abs(gm - gs) <= (1e-6 if i == 0 or not lossy else 1e-3) * abs(gs), step
        # Adam moves an element by about lr g / |g|: a gradient near 0 summed
        # in another order moves it by a fraction of lr either way; a lossy
        # round adds what two roundings of one payload can differ by
        first = r["steps"][0]
        assert first["master_gap"] <= 0.1 * LR + 2 * first["codec_atol"], first
        if not lossy:
            assert r["steps"][1]["master_gap"] <= 0.1 * LR, r["steps"][1]
        assert r["moment_spread"] == 0.0, r["moment_spread"]
        want_nodes = 1 if "moe" in key or "arctic" in key else MESHES[key.split("/")[0]][0]
        assert r["nodes"] == want_nodes


def test_meshed_trainer_matches_the_jax_trainer(results):
    r = results[0]["jax"]
    (got, want), (gn, gw) = r["loss"], r["grad_norm"]
    assert abs(got - want) <= 1e-5 * abs(want)
    assert abs(gn - gw) <= 1e-4 * gw
    assert r["params"] <= 0.1 * LR and r["master"] <= 0.1 * LR, r


@pytest.mark.parametrize("arch", GRAD_ARCHS)
@pytest.mark.parametrize("mesh", list(GRAD_MESHES))
def test_meshed_grads_with_sequence_split_and_vocab_parallel_loss(results, mesh, arch):
    for res in results:
        r = res["grads"][f"{mesh}/{arch}"]
        (got, want), (gn, gw) = r["loss"], r["norm"]
        assert abs(got - want) <= 1e-6 * abs(want), r
        assert abs(gn - gw) <= 1e-6 * gw and r["diff"] <= 1e-6 * gw, r
        # P9: the vocab-parallel loss; P10: the sequence split, both ways
        assert r["calls"].get("_VocabParallelCE", 0) >= 1, r
        assert r["calls"].get("_SeqGather", 0) > 0 and r["calls"].get("_SeqScatter", 0) > 0, r


def test_train_cli_on_a_mesh(results):
    out = results[0]["cli"]["stdout"].splitlines()
    head = [ln for ln in out if ln.startswith("arch=")]
    assert head and "nodes=2" in head[0] and "mst_slots=" in head[0], out
    steps = [ln for ln in out if ln.startswith("step ")]
    assert len(steps) == 2 and "loss=" in steps[0] and "gnorm=" in steps[0], out
    done = [ln for ln in out if ln.startswith("done: 2 steps")]
    assert done, out
    assert all(not r["cli"]["stdout"] for r in results[1:])  # rank 0 alone logs
    errors = results[0]["cli"]["errors"]
    assert "--nodes" in errors["--mesh 2x2 --nodes 4"], errors
    assert "need 8 ranks" in errors["--mesh 4x2"], errors


def test_train_cli_on_a_mesh_writes_each_nodes_checkpoint(results):
    """Each node's first rank writes the node's parameters, gathered over
    "model", where the stacked run writes that node's row."""
    from repro_torch.checkpoint import node_checkpoint_path, restore_pytree
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    ckpt = results[0]["ckpt_dir"]
    like = build_model(get_arch("smollm-360m").smoke_variant(),
                       device="cpu").init(torch.Generator().manual_seed(0))
    for node in range(2):
        tree = restore_pytree(node_checkpoint_path(ckpt, node, 2), like)
        leaves, want = [], []
        _walk(tree, leaves), _walk(like, want)
        assert [t.shape for t in leaves] == [t.shape for t in want]
        assert all(torch.isfinite(t.float()).all() for t in leaves)


def _walk(tree, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], out)
    else:
        out.append(tree)
