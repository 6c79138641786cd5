"""The port's moe layer against the JAX package's, on the CPU.

``repro_torch.models.moe.moe_layer`` and ``repro.models.moe.moe_layer`` run
on the same weights (``convert.from_numpy`` of the JAX ``init_moe`` tree) and
the same f32 activations, made with numpy from a seed:

* y within 1e-5 of max |y| and the aux loss within 1e-6, at s = 48 (three
  groups of 16), at a prime s = 47 (the group size steps down to 1) and with
  arctic's dense residual MLP; the f counts equal, token for token, the top-k
  choices the JAX package's own ops make, and the P sums are within 1e-6 of
  theirs (another summation order);
* a zero router, where every expert ties: both pick experts 0..k-1 for every
  token (``jax.lax.top_k``'s rule; ``torch.topk`` picks the higher indices),
  and capacity drops most of the slots;
* gradients of the layer within 1e-5 of each leaf's max |g|;
* the group size and capacity the full configs give (qwen3-moe-30b-a3b: gs
  64, 32 groups, capacity 5; arctic-480b: 256, 8, 5; decode: 1, 1);
* the moe param tree (an f32 router beside bf16 experts) and Adafactor's
  factored state cross to the port and back bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.optim.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    from_numpy,
    to_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.models import moe as pt_moe  # noqa: E402

D, FF, E = 64, 32, 4


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _pair(dense_ff=0, n_experts=E, seed=0):
    params_j = jax_moe.init_moe(jax.random.PRNGKey(seed), D, FF, n_experts, jnp.float32,
                                dense_ff)
    return params_j, from_numpy(params_j, device="cpu")


def _x(b, s, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(b, s, D))).astype(np.float32)


def _jax_sums(params_j, x, top_k):
    """The f counts and P sums of ``repro/models/moe.py:92-96,137-138``, by
    the JAX package's own ops over every token (the router acts token by
    token, so the grouping does not change them)."""
    logits = jnp.einsum("bsd,de->bse", x, params_j["router"].astype(x.dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    n = params_j["router"].shape[1]
    return (np.asarray(jax.nn.one_hot(idx, n).sum(axis=(0, 1, 2))),
            np.asarray(probs.sum(axis=(0, 1))))


@pytest.mark.parametrize("s,dense_ff,top_k", [(48, 0, 2), (47, 0, 2), (48, 48, 2), (48, 0, 1)],
                         ids=["s48", "prime-s47", "dense-residual", "top1"])
def test_moe_layer_matches_jax(s, dense_ff, top_k):
    params_j, params_t = _pair(dense_ff)
    x = _x(2, s, scale=20.0)  # router logits of std ~ 2: uneven loads, drops
    want_y, want_aux = jax_moe.moe_layer(params_j, jnp.asarray(x), top_k)
    y, aux, stats = pt_moe.moe_layer(params_t, torch.from_numpy(x), top_k)
    want_y = np.asarray(want_y)
    assert y.shape == want_y.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), want_y, atol=1e-5 * float(np.abs(want_y).max()))
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    want_f, want_p = _jax_sums(params_j, jnp.asarray(x), top_k)
    np.testing.assert_array_equal(stats.f.numpy(), want_f)
    np.testing.assert_allclose(stats.p.detach().numpy(), want_p, rtol=1e-6)
    assert stats.tokens == 2 * s and float(stats.f.sum()) == top_k * 2 * s
    assert stats.f.grad_fn is None and stats.p.grad_fn is None  # no graph asked for


def test_zero_router_ties_go_to_the_lower_experts():
    """Every expert ties: jax.lax.top_k takes experts 0..k-1, and so must
    the port (torch.topk would take others); with 8 experts, top 2 and
    groups of 16, capacity is 5 of the 16 slots each of the two experts
    gets, so most slots drop, in the same places."""
    params_j, params_t = _pair(n_experts=8)
    params_j = dict(params_j, router=jnp.zeros_like(params_j["router"]))
    params_t = dict(params_t, router=torch.zeros_like(params_t["router"]))
    x = _x(2, 48, seed=3)
    want_y, want_aux = jax_moe.moe_layer(params_j, jnp.asarray(x), 2)
    y, aux, stats = pt_moe.moe_layer(params_t, torch.from_numpy(x), 2)
    assert stats.f.tolist() == [96.0, 96.0] + [0.0] * 6
    _, jax_idx = jax.lax.top_k(jnp.zeros((1, 8)), 2)
    assert np.asarray(jax_idx).tolist() == [[0, 1]]
    assert pt_moe.route(torch.full((3, 8), 0.125), 2)[1].tolist() == [[0, 1]] * 3
    gs, capacity = pt_moe.group_size(48, 8, 2, 1.25)
    assert (gs, capacity) == (16, 5)
    want_y = np.asarray(want_y)
    np.testing.assert_allclose(y.numpy(), want_y, atol=1e-5 * float(np.abs(want_y).max()))
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    # the drops: a group's first 5 tokens reach both experts, the rest neither
    kept = (y.abs().sum(-1) > 0).reshape(2, 3, 16)
    assert bool(kept[..., :5].all()) and not bool(kept[..., 5:].any())


@pytest.mark.parametrize("dense_ff", (0, 48), ids=["experts", "dense-residual"])
def test_moe_layer_grads_match_jax(dense_ff):
    params_j, params_t = _pair(dense_ff)
    x = _x(2, 32, scale=20.0)
    r = np.random.default_rng(5).normal(size=(2, 32, D)).astype(np.float32)

    def loss_j(p, x):
        y, aux = jax_moe.moe_layer(p, x, 2)
        return jnp.sum(y * r) + aux

    want_gp, want_gx = jax.grad(loss_j, argnums=(0, 1))(params_j, jnp.asarray(x))
    leaves = [t.requires_grad_(True) for _, t in _leaves(params_t)]
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux, _ = pt_moe.moe_layer(params_t, xt, 2)
    got = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux, leaves + [xt])
    want = [w for _, w in _leaves(jax.device_get(want_gp))] + [np.asarray(want_gx)]
    for (name, _), g, w in zip(list(_leaves(params_t)) + [("x", None)], got, want):
        w = np.asarray(w)
        err, scale = float(np.abs(g.numpy() - w).max()), float(np.abs(w).max())
        assert scale > 0 and err <= 1e-5 * scale, f"{name}: {err} > 1e-5 x {scale}"


@pytest.mark.parametrize("arch,gs,groups,capacity", [
    ("qwen3-moe-30b-a3b", 64, 32, 5), ("arctic-480b", 256, 8, 5)])
def test_group_size_and_capacity_of_the_full_configs(arch, gs, groups, capacity):
    cfg = pt_configs.get_arch(arch)
    got = pt_moe.group_size(2048, cfg.n_experts, cfg.top_k, cfg.moe_capacity_factor)
    assert got == (gs, capacity) and 2048 // got[0] == groups
    assert pt_moe.group_size(1, cfg.n_experts, cfg.top_k, cfg.moe_capacity_factor) == (1, 1)


def test_moe_tree_crosses_with_an_f32_router_beside_bf16_experts():
    cfg = jax_configs.get_arch("arctic-480b").smoke_variant().replace(dtype="bfloat16")
    params_j = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    params_t = from_numpy(params_j, device="cpu")
    want, got = dict(_leaves(params_j)), dict(_leaves(params_t))
    assert sorted(got) == sorted(want)
    assert got["/blocks/moe/router"].dtype == torch.float32
    assert got["/blocks/moe/wg"].dtype == torch.bfloat16
    assert tuple(got["/blocks/moe/wo"].shape) == (cfg.n_layers, cfg.n_experts, cfg.d_ff,
                                                  cfg.d_model)
    assert "/blocks/moe/dense/wg" in got
    for path, w in want.items():
        g = got[path]
        assert str(g.dtype)[6:] == w.dtype.name and tuple(g.shape) == w.shape, path
        bits = g.view(torch.int16) if g.dtype == torch.bfloat16 else g
        np.testing.assert_array_equal(bits.numpy(), np.asarray(w).view(bits.numpy().dtype),
                                      err_msg=path)
    back = dict(_leaves(to_numpy(params_t)))
    for path, w in want.items():
        np.testing.assert_array_equal(back[path].view(np.uint8), np.asarray(w).view(np.uint8))


def test_adafactor_factored_state_crosses_to_the_port_and_back():
    """arctic's optimizer: the JAX Adafactor state after one update (row /
    column factors of every rank >= 2 leaf, the expert leaves' included)
    becomes the port's TrainState, moments held once, and comes back."""
    cfg = jax_configs.get_arch("arctic-480b").smoke_variant()
    params_j = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    opt = jax_make_optimizer(cfg, lr=1e-3, warmup=0)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.5, params_j)
    params_j, opt_j = opt.update(params_j, grads, opt.init(params_j), jnp.zeros((), jnp.int32))
    params_np, opt_np = jax.device_get(params_j), jax.device_get(opt_j)
    state = train_state_from_numpy(params_np, opt_np, 1, 4, device="cpu")
    assert sorted(state.opt_state) == ["f"]
    f = state.opt_state["f"]["blocks"]["moe"]["wg"]
    assert sorted(f) == ["vc", "vr"]
    assert tuple(f["vr"].shape) == (cfg.n_layers, cfg.n_experts, cfg.d_model)
    assert tuple(f["vc"].shape) == (cfg.n_layers, cfg.n_experts, cfg.d_ff)
    for (name, g), (_, w) in zip(_leaves(state.opt_state["f"]), _leaves(opt_np["f"])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for (name, g), (_, w) in zip(_leaves(state.params), _leaves(params_np)):
        assert g.shape[0] == 4 and all(np.array_equal(g[i].numpy(), w) for i in range(4)), name
    params_back, opt_back, step = train_state_to_numpy(state, node=3)
    assert step == 1
    for (name, g), (_, w) in zip(_leaves(opt_back["f"]), _leaves(opt_np["f"])):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    for (name, g), (_, w) in zip(_leaves(params_back), _leaves(params_np)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
