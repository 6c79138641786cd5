"""The port's optimizers (``repro_torch.optim``) against the JAX package's.

Each optimizer takes the same params, grads and state on both sides, one
update at a time (the JAX package's state after each update is fed to both
for the next): SGD with weight decay, momentum (f32 and bf16 moments),
AdamW (f32 and bf16 moments, with and without fp32 masters, f32 and bf16
params) and Adafactor (rank-1, rank-2 and rank-3 leaves). f32 results
within 1e-6 relative of the leaf's max |x| (XLA contracts some multiply-adds
into FMAs; PyTorch does not), bf16 ones within one bf16 step. The schedules
at steps across warm-up and decay, global_norm and clip_by_global_norm
(both sides of the threshold), and make_optimizer's choice per arch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.optim import optimizers as jo  # noqa: E402
from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch.convert import from_numpy, to_numpy  # noqa: E402
from repro_torch.optim import optimizers as po  # noqa: E402

SHAPES = {"w": (6, 5), "t": (3, 4, 5), "b": (7,), "nested": {"u": (2, 9)}}
STEPS = (0, 1, 7)


def _tree(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(v, rng, scale) for k, v in shapes.items()}
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _cast(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _assert_close(got, want, rtol=1e-6):
    flat_want, flat_got = jax.tree_util.tree_flatten_with_path(want)[0], po.tree_leaves(got)
    assert len(flat_want) == len(flat_got)
    for (path, w), g in zip(flat_want, flat_got):
        w = jnp.asarray(w)
        assert g.shape == w.shape, path
        g64 = g.double().numpy()
        w64 = np.asarray(w.astype(jnp.float32), np.float64)
        if w.dtype == jnp.bfloat16:  # one bf16 step of the value
            tol = np.abs(w64) * 2.0 ** -7 + 1e-30
            assert (np.abs(g64 - w64) <= tol).all(), path
        else:
            scale = max(float(np.abs(w64).max()), 1e-30)
            assert float(np.abs(g64 - w64).max()) <= rtol * scale, path


def _to_torch(tree):
    return from_numpy(jax.device_get(tree), device="cpu")


def _run(jax_opt, pt_opt, param_dtype=jnp.float32):
    rng = np.random.default_rng(0)
    params = _cast(_tree(SHAPES, rng), param_dtype)
    state = jax_opt.init(params)
    pt_state0 = pt_opt.init(_to_torch(params))
    # the two packages initialise the same state
    _assert_close(pt_state0, state)
    for step in STEPS:
        grads = _cast(_tree(SHAPES, rng, scale=0.1), param_dtype)
        new_p, new_s = jax_opt.update(params, grads, state, jnp.asarray(step, jnp.int32))
        got_p, got_s = pt_opt.update(_to_torch(params), _to_torch(grads), _to_torch(state),
                                     torch.tensor(step, dtype=torch.int32))
        _assert_close(got_p, new_p)
        _assert_close(got_s, new_s)
        params, state = new_p, new_s


SCHED = (po.cosine_schedule(1e-3, 100, 10_000), jo.cosine_schedule(1e-3, 100, 10_000))


@pytest.mark.parametrize("case", [
    "sgd", "sgd_wd", "momentum_f32", "momentum_bf16", "adamw_master_f32",
    "adamw_master_bf16_moments", "adamw_no_master", "adamw_bf16_params",
    "adamw_bf16_params_no_master", "adafactor", "adafactor_wd"])
def test_optimizer_updates_match_jax(case):
    ps, js = SCHED
    pairs = {
        "sgd": (po.sgd(ps), jo.sgd(js)),
        "sgd_wd": (po.sgd(ps, weight_decay=0.1), jo.sgd(js, weight_decay=0.1)),
        "momentum_f32": (po.momentum_sgd(ps), jo.momentum_sgd(js)),
        "momentum_bf16": (po.momentum_sgd(ps, moment_dtype=torch.bfloat16),
                          jo.momentum_sgd(js, moment_dtype=jnp.bfloat16)),
        "adamw_master_f32": (po.adamw(ps), jo.adamw(js)),
        "adamw_master_bf16_moments": (po.adamw(ps, moment_dtype=torch.bfloat16),
                                      jo.adamw(js, moment_dtype=jnp.bfloat16)),
        "adamw_no_master": (po.adamw(ps, master_fp32=False), jo.adamw(js, master_fp32=False)),
        "adamw_bf16_params": (po.adamw(ps), jo.adamw(js)),
        "adamw_bf16_params_no_master": (po.adamw(ps, master_fp32=False),
                                        jo.adamw(js, master_fp32=False)),
        "adafactor": (po.adafactor(ps), jo.adafactor(js)),
        "adafactor_wd": (po.adafactor(ps, weight_decay=0.1), jo.adafactor(js, weight_decay=0.1)),
    }
    pt_opt, jax_opt = pairs[case]
    assert pt_opt.name == jax_opt.name
    _run(jax_opt, pt_opt, jnp.bfloat16 if "bf16_params" in case else jnp.float32)


@pytest.mark.parametrize("kind", ["constant", "cosine", "linear"])
def test_schedules_match_jax(kind):
    make = {"constant": (lambda m: m.constant_schedule(3e-4)),
            "cosine": (lambda m: m.cosine_schedule(3e-4, 100, 10_000)),
            "linear": (lambda m: m.linear_schedule(3e-4, 100, 10_000))}[kind]
    got_fn, want_fn = make(po), make(jo)
    for step in (0, 1, 50, 99, 100, 101, 2500, 9999, 10_000, 12_000):
        got = float(got_fn(torch.tensor(step, dtype=torch.int32)))
        want = float(want_fn(jnp.asarray(step, jnp.int32)))
        assert abs(got - want) <= 1e-6 * 3e-4, (step, got, want)
    # warm-up 0: the first step already runs at lr (the trainer tests rely on it)
    assert float(po.cosine_schedule(1e-3, 0, 100)(torch.tensor(0))) == pytest.approx(1e-3)


@pytest.mark.parametrize("scale", [0.01, 10.0])  # below and above max_norm = 1
def test_clip_by_global_norm_matches_jax(scale):
    rng = np.random.default_rng(2)
    tree = _tree(SHAPES, rng, scale=scale)
    tree = dict(tree, b=jnp.asarray(tree["b"], jnp.bfloat16))
    want, want_norm = jo.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    got, got_norm = po.clip_by_global_norm(_to_torch(tree), 1.0)
    assert abs(float(got_norm) - float(want_norm)) <= 1e-6 * float(want_norm)
    assert abs(float(po.global_norm(_to_torch(tree))) - float(jo.global_norm(tree))) <= \
        1e-6 * float(want_norm)
    _assert_close(got, want)
    assert got["b"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", pt_configs.list_archs())
def test_make_optimizer_matches_jax(arch):
    cfg_t, cfg_j = pt_configs.get_arch(arch), jax_configs.get_arch(arch)
    got, want = po.make_optimizer(cfg_t), jo.make_optimizer(cfg_j)
    assert got.name == want.name
    params = {"w": np.zeros((3, 2), np.float32)}
    got_s = got.init(from_numpy(params, device="cpu"))
    want_s = want.init(jax.tree.map(jnp.asarray, params))
    assert sorted(got_s) == sorted(want_s)
    for k in got_s:
        assert str(got_s[k]["w"].dtype).split(".")[-1] == str(want_s[k]["w"].dtype)
    assert to_numpy(got_s)["m"]["w"].shape == (3, 2)
