"""The port's sharding recipes (``repro_torch.dfl.sharding``) against the JAX
package's (``repro.dfl.sharding``), on the CPU with no process group.

Both meshes are ``tests/test_sharding.py``'s duck-typed ``FakeMesh`` (the
spec builders read axis sizes only): ``16x16`` (data, model) and
``2x16x16`` (pod, data, model).

* ``param_spec_tree`` of every arch equals the JAX package's on
  ``jax.eval_shape(model.init)`` leaf by leaf, dimension by dimension (the
  port's tree from ``Model.init`` traced on fake tensors: the same keys and
  shapes);
* ``cache_spec_tree`` the same at ``decode_32k`` and ``long_500k`` (whisper's
  long_500k skipped, as its config skips it);
* ``batch_axes`` / ``batch_spec`` at global batches 256, 32, 2 and 1;
* ``named`` gives ``Shard(d)`` on each mesh dimension that an entry of
  dimension d names and ``Replicate()`` elsewhere, a dimension split over
  ("pod", "data") on both mesh dimensions;
* ``local_shape`` divides each dimension by the product of its axes;
* ``make_production_mesh`` and ``make_local_mesh`` raise, naming the ranks
  they need, when the default process group has fewer (none here).
"""
import functools

import pytest

torch = pytest.importorskip("torch")
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.dfl import sharding as jax_sharding  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch.dfl import sharding  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


class FakeMesh:
    """Duck-typed mesh: the spec builders only read .shape."""

    def __init__(self, **axes):
        self.shape = dict(axes)


MESHES = {
    "16x16": FakeMesh(data=16, model=16),
    "2x16x16": FakeMesh(pod=2, data=16, model=16),
}
ARCHS = pt_configs.list_archs()
CACHE_SHAPES = ("decode_32k", "long_500k")


def _entries(spec, ndim):
    """A spec's entries, one a dimension, each a tuple of axis names."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        out.append(() if e is None else tuple(e) if isinstance(e, tuple) else (e,))
    return out


def _jax_leaves(tree, specs):
    """{path: (shape, spec)} of a JAX shape tree and its spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    return {tuple(k.key for k in path): (tuple(leaf.shape), spec)
            for (path, leaf), spec in zip(leaves, spec_leaves)}


def _pt_leaves(tree, specs, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_pt_leaves(tree[k], specs[k], path + (k,)))
        return out
    assert isinstance(specs, sharding.Spec), (path, specs)
    return {path: (tuple(tree.shape), specs)}


def _assert_same(jax_tree, jax_specs, pt_tree, pt_specs, label):
    want = _jax_leaves(jax_tree, jax_specs)
    got = _pt_leaves(pt_tree, pt_specs)
    assert sorted(got) == sorted(want), label
    for path, (shape, spec) in want.items():
        pt_shape, pt_spec = got[path]
        assert pt_shape == shape, (label, path)
        assert _entries(pt_spec, len(shape)) == _entries(spec, len(shape)), \
            (label, path, pt_spec, spec)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    model = jax_build_model(jax_configs.get_arch(arch))
    return jax.eval_shape(model.init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _pt_params(arch):
    return sharding.param_shapes(build_model(pt_configs.get_arch(arch), device="cpu"))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh_name):
    mesh = MESHES[mesh_name]
    cfg_j, cfg_t = jax_configs.get_arch(arch), pt_configs.get_arch(arch)
    jp, tp = _jax_params(arch), _pt_params(arch)
    _assert_same(jp, jax_sharding.param_spec_tree(cfg_j, jp, mesh), tp,
                 sharding.param_spec_tree(cfg_t, tp, mesh), f"{arch}@{mesh_name}")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", CACHE_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_jax(arch, shape_name, mesh_name):
    cfg_j, cfg_t = jax_configs.get_arch(arch), pt_configs.get_arch(arch)
    if shape_name in cfg_t.skip_shapes:
        assert shape_name in cfg_j.skip_shapes
        return
    mesh = MESHES[mesh_name]
    shape = pt_configs.INPUT_SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    model_j = jax_build_model(cfg_j, shape_name)
    jc = jax.eval_shape(lambda: model_j.init_cache(b, s))
    tc = build_model(cfg_t, shape_name, device="cpu")._init_cache(b, s, torch.device("meta"))
    _assert_same(jc, jax_sharding.cache_spec_tree(cfg_j, jc, mesh, b), tc,
                 sharding.cache_spec_tree(cfg_t, tc, mesh, b),
                 f"{arch}/{shape_name}@{mesh_name}")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("batch", [256, 32, 2, 1])
def test_batch_axes_and_spec_match_jax(batch, mesh_name):
    mesh = MESHES[mesh_name]
    assert sharding.batch_axes(mesh, batch) == jax_sharding.batch_axes(mesh, batch)
    for rank in (1, 2, 3):
        got = sharding.batch_spec(mesh, batch, rank)
        want = jax_sharding.batch_spec(mesh, batch, rank)
        assert _entries(got, rank) == _entries(want, rank), (batch, rank)


def _placements_follow(mesh, spec, placements):
    names = list(mesh.shape)
    assert len(placements) == len(names)
    for i, p in enumerate(placements):
        dims = [d for d, e in enumerate(_entries(spec, len(spec))) if names[i] in e]
        if dims:
            assert p == Shard(dims[0]), (spec, placements)
        else:
            assert p == Replicate(), (spec, placements)


@pytest.mark.parametrize("spec, want", [
    (sharding.Spec(("pod", "data"), None, "model"), (Shard(0), Shard(0), Shard(2))),
    (sharding.Spec(None, "data", None, "model"), (Replicate(), Shard(1), Shard(3))),
    (sharding.Spec(), (Replicate(), Replicate(), Replicate())),
    (sharding.Spec(("pod",), None), (Shard(0), Replicate(), Replicate())),
])
def test_named_placements(spec, want):
    mesh = MESHES["2x16x16"]
    assert sharding.placements(mesh, spec) == want
    assert sharding.named(mesh, {"a": {"b": spec}}) == {"a": {"b": want}}
    _placements_follow(mesh, spec, want)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["arctic-480b", "falcon-mamba-7b", "qwen3-moe-30b-a3b",
                                  "zamba2-7b"])
def test_named_follows_every_param_spec(arch, mesh_name):
    mesh = MESHES[mesh_name]
    tp = _pt_params(arch)
    specs = sharding.param_spec_tree(pt_configs.get_arch(arch), tp, mesh)
    named = sharding.named(mesh, specs)
    leaves = _pt_leaves(tp, specs)
    for path, (shape, spec) in leaves.items():
        pl = named
        for k in path:
            pl = pl[k]
        _placements_follow(mesh, spec, pl)
        local = sharding.local_shape(mesh, spec, shape)
        for d, e in enumerate(_entries(spec, len(shape))):
            n = 1
            for a in e:
                n *= mesh.shape[a]
            assert local[d] * n == shape[d], (path, spec)


def test_local_shape_rejects_a_split_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        sharding.local_shape(MESHES["16x16"], sharding.Spec("model"), (24,))


@pytest.mark.parametrize("multi_pod, ranks", [(False, 256), (True, 512)])
def test_production_mesh_names_the_ranks_it_needs(multi_pod, ranks):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match=f"need {ranks} ranks.*fake process group"):
        make_production_mesh(multi_pod=multi_pod, device="cpu")
    with pytest.raises(RuntimeError, match="need 4 ranks"):
        make_local_mesh((2, 2), device="cpu")
    assert not dist.is_initialized()
