"""The port's gossip round against ``repro.dfl.collectives.gossip_exchange``.

Every mode, with every codec its rules allow, a bf16 tree wire and the
error-feedback dissemination path, at n in {2, 4, 8} nodes, with and
without a churned node. The JAX references run in one subprocess per n
(``--xla_force_host_platform_device_count=n`` must be set before jax
imports), all three at once; each writes an ``.npz`` that a module-scoped
fixture reads.

Tolerances: tree_allreduce (raw or bf16 wire) and mixing are bit-identical
(same f32 ops in the same order). A lossy tree wire is held to 1e-6 of the
partial sums' scale, n · max|x|: the wire buffers are bit-identical, but XLA
contracts the decode's multiply and the accumulate into one FMA. Where the mix kernel
replaces ``jnp.mean`` (dissemination, segmented, flooding) and for the
all-reduce reference, the sum order differs: within 1e-6 · max|x|. Lossy
codecs are also held to the exact mean within ``codec.mean_atol`` (times n
where each hop re-encodes a partial sum). A codec's round over a tree of
several leaves, hopped a group at a time, must equal (``torch.equal``) the
same round leaf by leaf.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compress import codec as codec_module  # noqa: E402
from repro_torch.compress import make_codec  # noqa: E402
from repro_torch.dfl import collectives  # noqa: E402
from repro_torch.dfl.collectives import (  # noqa: E402
    CODEC_MODES,
    GossipPlan,
    gossip_collective_bytes,
    gossip_exchange,
    hop_groups,
    tree_flatten,
)
from repro_torch.dfl.session import plan_for_members  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = (2, 4, 8)
MODES = ("tree_allreduce", "dissemination", "segmented", "mixing", "flooding",
         "allreduce_ref")
LEAVES = {"w": (50, 61), "b": (1027,)}  # sizes no chunk/block/segment count divides
CHURNED = 1  # the node that leaves in the churned cases


def _cases():
    out = []
    for n in NS:
        for churn in ((False, True) if n > 2 else (False,)):
            variants = [(m, None, None, False) for m in MODES]
            variants += [(m, c, None, False) for m in CODEC_MODES
                         for c in ("int8", "int4", "topk")]
            variants += [("tree_allreduce", None, "bf16", False),
                         ("dissemination", "topk", None, True),
                         ("dissemination", "int8", None, True)]
            for mode, codec, wire, ef in variants:
                out.append(dict(n=n, churn=churn, mode=mode, codec=codec, wire=wire, ef=ef,
                                jax=mode != "mixing" or _jax_can_mix(n, churn)))
    return out


def _jax_can_mix(n, churn):
    """Whether the JAX mixing body runs this plan. It raises on a churned
    plan (its membership mask is sized by the live count but indexed by
    physical id) and on a matching whose pairs share a node (its
    two-way permutation then repeats a source)."""
    if churn:
        return False
    plan = GossipPlan.build(n)
    return all(len({x for e in m for x in e}) == 2 * len(m) for m in plan.mixing_matchings)


CASES = _cases()


def _case_id(c):
    parts = [f"n{c['n']}", c["mode"], c["codec"] or "raw"]
    if c["wire"]:
        parts.append(f"wire_{c['wire']}")
    if c["ef"]:
        parts.append("ef")
    if c["churn"]:
        parts.append("churn")
    return "-".join(parts)


def _inputs(n):
    rng = np.random.default_rng(1000 + n)
    params = {k: rng.normal(size=(n, *s)).astype(np.float32) for k, s in LEAVES.items()}
    ef = {k: (0.1 * rng.normal(size=(n, *s))).astype(np.float32) for k, s in LEAVES.items()}
    return params, ef


JAX_REF = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.compress import make_codec
    from repro.dfl.collectives import GossipPlan, gossip_exchange
    from repro.dfl.session import _plan_for_members

    n, cases_path, in_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    cases = json.load(open(cases_path))
    data = np.load(in_path)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    keys = sorted({k.split("/")[1] for k in data.files})
    sh = NamedSharding(mesh, P("data"))
    params = {k: jax.device_put(data["params/" + k], sh) for k in keys}
    ef = {k: jax.device_put(data["ef/" + k], sh) for k in keys}
    specs = {k: P("data") for k in keys}
    plans = {False: GossipPlan.build(mesh, ("data",)),
             True: _plan_for_members(mesh, ("data",), set(range(n)) - {CHURNED})}
    out = {}
    for cid, c in cases:
        codec = make_codec(c["codec"]) if c["codec"] else None
        wire = jnp.bfloat16 if c["wire"] == "bf16" else None
        plan = plans[c["churn"]]
        if c["ef"]:
            res, new_ef = jax.jit(lambda t, e: gossip_exchange(
                c["mode"], plan, mesh, t, specs, codec=codec, ef_state=e))(params, ef)
            for k in keys:
                out[f"{cid}/ef/{k}"] = np.asarray(new_ef[k])
        else:
            res = jax.jit(lambda t: gossip_exchange(
                c["mode"], plan, mesh, t, specs, wire_dtype=wire, codec=codec))(params)
        for k in keys:
            out[f"{cid}/{k}"] = np.asarray(res[k])
    np.savez(out_path, **out)
""").replace("CHURNED", str(CHURNED))


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    """Run the JAX references, one subprocess per n, all at once."""
    tmp = tmp_path_factory.mktemp("jax_collectives")
    procs = {}
    for n in NS:
        params, ef = _inputs(n)
        np.savez(tmp / f"in{n}.npz", **{f"params/{k}": v for k, v in params.items()},
                 **{f"ef/{k}": v for k, v in ef.items()})
        cases = [(_case_id(c), c) for c in CASES if c["n"] == n and c["jax"]]
        (tmp / f"cases{n}.json").write_text(json.dumps(cases))
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"),
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={n}")
        procs[n] = subprocess.Popen(
            [sys.executable, "-c", JAX_REF, str(n), str(tmp / f"cases{n}.json"),
             str(tmp / f"in{n}.npz"), str(tmp / f"out{n}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    outs = {}
    for n, proc in procs.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"JAX reference n={n} failed:\n{err[-4000:]}"
        outs[n] = dict(np.load(tmp / f"out{n}.npz"))
    return outs


def _port_plan(n, churn):
    if churn:
        return plan_for_members(n, set(range(n)) - {CHURNED})
    return GossipPlan.build(n)


def _to_torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_gossip_exchange_matches_jax(case, jax_outputs):
    n, cid = case["n"], _case_id(case)
    params, ef = _inputs(n)
    plan = _port_plan(n, case["churn"])
    codec = make_codec(case["codec"]) if case["codec"] else None
    wire = torch.bfloat16 if case["wire"] == "bf16" else None
    if case["ef"]:
        out, new_ef = gossip_exchange(case["mode"], plan, _to_torch(params),
                                      codec=codec, ef_state=_to_torch(ef))
    else:
        out = gossip_exchange(case["mode"], plan, _to_torch(params), wire_dtype=wire,
                              codec=codec)
    if not case["jax"]:
        _check_mixing_against_numpy(plan, params, out, case["churn"])
        return
    ref = jax_outputs[n]
    # XLA contracts a decoded hop's multiply into the tree's accumulate (an
    # FMA), so a lossy tree wire is held to 1e-6 of the partial sums' scale
    exact = case["mode"] == "mixing" or (case["mode"] == "tree_allreduce"
                                         and case["codec"] is None)
    scale = n if case["mode"] == "tree_allreduce" else 1
    members = [u for u in range(n) if not (case["churn"] and u == CHURNED)]
    for k, x in params.items():
        got, want = out[k].numpy(), ref[f"{cid}/{k}"]
        assert got.shape == want.shape and got.dtype == want.dtype
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 1e-6 * scale * np.abs(x).max(), k
        if case["churn"] and case["mode"] not in ("flooding", "allreduce_ref"):
            np.testing.assert_array_equal(got[CHURNED], x[CHURNED])
        bound = codec.mean_atol(float(np.abs(x).max())) if codec is not None else None
        if bound is not None and case["mode"] != "allreduce_ref" and not case["ef"]:
            live = members if case["mode"] != "flooding" else list(range(n))
            exact_mean = x[live].astype(np.float64).mean(axis=0)
            assert np.abs(got[members] - exact_mean).max() <= bound * scale + 1e-5
        if case["ef"]:  # comp - decode(encode(comp)); XLA fuses the int8 decode (FMA)
            got_ef, want_ef = new_ef[k].numpy(), ref[f"{cid}/ef/{k}"]
            assert np.abs(got_ef - want_ef).max() <= 1e-6 * np.abs(x).max(), k


@pytest.mark.parametrize("mode", MODES)
def test_collective_bytes_match_jax(mode):
    from jax.sharding import PartitionSpec  # noqa: F401  (jax importable here)
    import types

    from repro.compress import make_codec as jax_make_codec
    from repro.dfl.collectives import gossip_collective_bytes as jax_bytes
    from repro.dfl.session import _plan_for_members

    for n in NS:
        mesh = types.SimpleNamespace(shape={"data": n})
        members = set(range(n)) - ({CHURNED} if n > 2 else set())
        jplan = _plan_for_members(mesh, ("data",), members)
        tplan = plan_for_members(n, members)
        for codec in (None, "int8", "int4", "topk", "bf16"):
            jc = jax_make_codec(codec) if codec else None
            tc = make_codec(codec) if codec else None
            assert (gossip_collective_bytes(mode, tplan, 21.2e6, tc)
                    == jax_bytes(mode, jplan, 21.2e6, jc))


def test_codec_rules_match_jax():
    plan = GossipPlan.build(4)
    params = {"w": torch.zeros(4, 8)}
    with pytest.raises(ValueError, match="does not support a payload codec"):
        gossip_exchange("mixing", plan, params, codec=make_codec("int8"))
    with pytest.raises(ValueError, match="needs a"):
        gossip_exchange("dissemination", plan, params, ef_state=params)
    with pytest.raises(ValueError, match="dissemination mode only"):
        gossip_exchange("segmented", plan, params, codec=make_codec("topk"),
                        ef_state=params)
    with pytest.raises(ValueError, match="unknown gossip mode"):
        gossip_exchange("bogus", plan, params)
    # the fp32 codec is the plain wire
    out = gossip_exchange("tree_allreduce", plan, {"w": torch.arange(32.).reshape(4, 8)},
                          codec=make_codec("fp32"))
    np.testing.assert_allclose(out["w"].numpy(),
                               np.broadcast_to(np.arange(32.).reshape(4, 8).mean(0), (4, 8)))


def _check_mixing_against_numpy(plan, params, out, churn):
    """Where the JAX mixing body cannot run, hold the port to a numpy pass:
    each matching split greedily into node-disjoint pairs, each matched pair
    averaged in f32; masked nodes keep their params."""
    for k, x in params.items():
        want = x.copy()
        for matching in plan.mixing_matchings:
            rest = list(matching)
            while rest:
                used, later, nxt = set(), [], want.copy()
                for u, v in rest:
                    if u in used or v in used:
                        later.append((u, v))
                        continue
                    used.update((u, v))
                    nxt[u] = np.float32(0.5) * want[u] + np.float32(0.5) * want[v]
                    nxt[v] = np.float32(0.5) * want[v] + np.float32(0.5) * want[u]
                want, rest = nxt, later
        np.testing.assert_array_equal(out[k].numpy(), want)
        if churn:
            np.testing.assert_array_equal(out[k].numpy()[CHURNED], x[CHURNED])


def test_caller_params_are_not_written():
    plan = GossipPlan.build(4)
    for mode in MODES:
        w = torch.arange(4 * 10, dtype=torch.float32).reshape(4, 10)
        before = w.clone()
        gossip_exchange(mode, plan, {"w": w})
        assert torch.equal(w, before), mode


# a tree of several leaves for the grouped hop: sizes no chunk, block or
# segment count divides, a one-element leaf and a bf16 leaf beside f32 ones
GROUP_LEAVES = {"w": ((50, 61), np.float32), "b": ((1027,), np.float32),
                "h": ((7, 33), "bf16"), "one": ((1,), np.float32),
                "deep": {"x": ((3, 1000), np.float32), "y": ((2, 5, 7), "bf16")}}


def _group_tree(n, seed=0):
    rng = np.random.default_rng(seed + n)

    def leaf(spec):
        if isinstance(spec, dict):
            return {k: leaf(v) for k, v in spec.items()}
        shape, dtype = spec
        x = torch.from_numpy(rng.normal(size=(n, *shape)).astype(np.float32) * 3)
        return x.bfloat16() if dtype == "bf16" else x

    return leaf(GROUP_LEAVES)


def _leaf_by_leaf(mode, plan, tree, codec, ef=None):
    """The per-leaf hop: gossip_exchange on each leaf as a tree of one."""
    leaves, rebuild = tree_flatten(tree)
    efs = tree_flatten(ef)[0] if ef is not None else [None] * len(leaves)
    outs, new_efs = [], []
    for x, e in zip(leaves, efs):
        if e is None:
            outs.append(gossip_exchange(mode, plan, {"x": x}, codec=codec)["x"])
        else:
            o, ne = gossip_exchange(mode, plan, {"x": x}, codec=codec, ef_state={"x": e})
            outs.append(o["x"])
            new_efs.append(ne["x"])
    return rebuild(outs), (rebuild(new_efs) if ef is not None else None)


def _assert_trees_equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


GROUP_CASES = [(n, mode, codec, churn, False) for n in (4, 8) for mode in CODEC_MODES
               for codec in ("int8", "int4", "topk", "bf16") for churn in (False, True)]
GROUP_CASES += [(n, "dissemination", codec, churn, True) for n in (4, 8)
                for codec in ("int8", "topk") for churn in (False, True)]


@pytest.mark.parametrize("n,mode,codec,churn,ef", GROUP_CASES, ids=[
    f"n{n}-{mode}-{codec}{'-ef' if ef else ''}{'-churn' if churn else ''}"
    for n, mode, codec, churn, ef in GROUP_CASES])
def test_grouped_hop_equals_leaf_by_leaf(n, mode, codec, churn, ef):
    """Every codec mode hops the whole tree as one group here (far under the
    budget) with a quantizer, a leaf at a time with a codec that decodes
    one leaf a call (top-k, bf16), and must give each leaf (and each
    error-feedback residual) the bits it gets as a tree of one."""
    plan = _port_plan(n, churn)
    tree = _group_tree(n)
    c = make_codec(codec)
    leaves = tree_flatten(tree)[0]
    whole = [list(range(len(leaves)))] if codec in ("int8", "int4") else \
        [[i] for i in range(len(leaves))]
    assert hop_groups(mode, plan, leaves, c) == whole
    if ef:
        residual = collectives.tree_map(lambda t: 0.1 * torch.ones_like(t, dtype=torch.float32)
                                        * t.float().sign(), tree)
        got, got_ef = gossip_exchange(mode, plan, tree, codec=c, ef_state=residual)
        want, want_ef = _leaf_by_leaf(mode, plan, tree, c, residual)
        _assert_trees_equal(got_ef, want_ef)
    else:
        got = gossip_exchange(mode, plan, tree, codec=c)
        want = _leaf_by_leaf(mode, plan, tree, c)[0]
    _assert_trees_equal(got, want)


@pytest.mark.parametrize("mode", CODEC_MODES)
def test_group_budget_splits_the_tree(mode, monkeypatch):
    """A small budget splits the tree into several groups (a leaf over it
    alone); each group's hop decodes once, and the round still equals the
    leaf-by-leaf round."""
    n, c = 4, make_codec("int8")
    plan = GossipPlan.build(n)
    tree = _group_tree(n, seed=3)
    leaves = tree_flatten(tree)[0]
    copies = n if mode in ("dissemination", "segmented") else 1
    sizes = [x.numel() * copies * (x.element_size() if copies > 1 else 4) for x in leaves]
    monkeypatch.setattr(collectives, "GROUP_BYTES", sizes[1] + sizes[2])
    groups = hop_groups(mode, plan, leaves, c)
    assert [i for g in groups for i in g] == list(range(len(leaves)))
    assert 2 < len(groups) < len(leaves)
    for g in groups:
        assert len(g) == 1 or sum(sizes[i] for i in g) <= sizes[1] + sizes[2]
    calls = []
    real = codec_module.dequantize_group_op

    def counted(codes, scales, layout):
        calls.append(layout.sizes)
        return real(codes, scales, layout)

    monkeypatch.setattr(codec_module, "dequantize_group_op", counted)
    got = gossip_exchange(mode, plan, tree, codec=c)
    steps = {"dissemination": len(plan.diss_steps), "segmented": len(plan.seg_steps),
             "tree_allreduce": len(plan.tree_steps), "flooding": 1}[mode]
    assert len(calls) == len(groups) * steps  # one decode a group a hop
    want = _leaf_by_leaf(mode, plan, tree, c)[0]
    _assert_trees_equal(got, want)


def test_without_a_codec_each_leaf_hops_alone():
    plan = GossipPlan.build(4)
    leaves = tree_flatten(_group_tree(4))[0]
    for mode in CODEC_MODES:
        assert hop_groups(mode, plan, leaves, None) == [[i] for i in range(len(leaves))]
