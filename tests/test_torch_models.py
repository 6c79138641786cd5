"""The port's models against the JAX package's ``Model``, on the CPU.

The JAX ``Model.init`` tree crosses to the port with ``convert.from_numpy``
leaf for leaf (stacked layer axis, nested ``embed/table``, bf16 as raw
bits); then both run the same tokens. On the f32 smoke variants of
smollm-360m, granite-3-2b, gemma2-2b (s above its smoke window of 128, so
the local layers' window bites) and falcon-mamba-7b:

* ``forward`` logits within 1e-4 of the JAX package's (f32; the attention
  and scan sum in another order than XLA's einsum and associative scan);
* ``decode_step`` logits within 1e-4 at every step and the caches within
  1e-5, gemma2's local ring wrapping past its window;
* teacher-forced decode within 5e-2 of the port's own forward, the bound of
  ``tests/test_models.py::test_decode_matches_forward``;
* the prefill forward reaches the flash-attention op once per dense layer
  and the selective-scan op once per Mamba1 layer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import Batch as JaxBatch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch.convert import from_numpy, to_numpy  # noqa: E402
from repro_torch.models import Batch, build_model  # noqa: E402
from repro_torch.models import attention as pt_attn  # noqa: E402
from repro_torch.models import mamba as pt_mamba  # noqa: E402

ARCHS = ("smollm-360m", "granite-3-2b", "gemma2-2b", "falcon-mamba-7b")
SEQ = {"gemma2-2b": 160}  # above the smoke window of 128
KEY = jax.random.PRNGKey(0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _pair(arch, shape_name=""):
    cfg_j = jax_configs.get_arch(arch).smoke_variant()
    cfg_t = pt_configs.get_arch(arch).smoke_variant()
    mj = jax_build_model(cfg_j, shape_name)
    mt = build_model(cfg_t, shape_name, device="cpu")
    params_j = mj.init(KEY)
    return mj, mt, params_j, from_numpy(params_j, device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    want, got = jax_configs.get_arch(arch), pt_configs.get_arch(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.smoke_variant()) == dataclasses.asdict(want.smoke_variant())
    assert (got.d_inner, got.dt_rank, got.resolved_head_dim) == \
        (want.d_inner, want.dt_rank, want.resolved_head_dim)


def test_registry_holds_the_ported_archs():
    assert pt_configs.list_archs() == sorted(ARCHS)
    assert set(pt_configs.INPUT_SHAPES) == set(jax_configs.INPUT_SHAPES)
    with pytest.raises(KeyError, match="ROADMAP"):
        pt_configs.get_arch("qwen3-moe-30b-a3b")


@pytest.mark.parametrize("family", ["moe", "hybrid", "audio", "vlm"])
def test_unported_families_raise(family):
    cfg = pt_configs.ArchConfig(name="x", family=family, source="")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_jax(arch):
    mj, mt, params_j, _ = _pair(arch)
    got = dict(_leaves(mt.init(torch.Generator().manual_seed(0))))
    want = dict(_leaves(params_j))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == w.dtype.name, path
        if path.rsplit("/", 1)[-1] in ("ln", "ln1", "ln2", "final_norm", "dt_bias", "D"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=path)


def test_from_numpy_carries_a_bf16_init_tree():
    cfg = jax_configs.get_arch("gemma2-2b").smoke_variant().replace(dtype="bfloat16")
    params_j = jax_build_model(cfg).init(KEY)
    params_t = from_numpy(params_j, device="cpu")
    want, got = dict(_leaves(params_j)), dict(_leaves(params_t))
    assert sorted(got) == sorted(want) and "/embed/table" in got
    assert got["/local_blocks/attn/wq"].shape[0] == cfg.n_layers // 2
    for path, w in want.items():
        g = got[path]
        assert str(g.dtype)[6:] == w.dtype.name and tuple(g.shape) == w.shape, path
        if g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          np.asarray(w).view(np.int16), err_msg=path)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=path)
    back = dict(_leaves(to_numpy(params_t)))
    for path, w in want.items():
        np.testing.assert_array_equal(back[path].view(np.uint8), np.asarray(w).view(np.uint8))


def _count_kernel_calls(monkeypatch):
    calls = {"flash": 0, "scan": 0}
    flash, scan = pt_attn.flash_attention_op, pt_mamba.selective_scan_op

    def counted_flash(*a, **k):
        calls["flash"] += 1
        return flash(*a, **k)

    def counted_scan(*a, **k):
        calls["scan"] += 1
        return scan(*a, **k)

    monkeypatch.setattr(pt_attn, "flash_attention_op", counted_flash)
    monkeypatch.setattr(pt_mamba, "selective_scan_op", counted_scan)
    return calls


@pytest.mark.parametrize("arch,shape_name", [(a, "") for a in ARCHS]
                         + [("smollm-360m", "long_500k")])
def test_forward_matches_jax(monkeypatch, arch, shape_name):
    mj, mt, params_j, params_t = _pair(arch, shape_name)
    cfg = mt.cfg
    b, s = 2, SEQ.get(arch, 160 if shape_name else 48)
    tokens = _tokens(cfg, b, s)
    labels = _tokens(cfg, b, s, seed=1)
    want, _ = jax.jit(mj.forward)(params_j, JaxBatch(tokens=jnp.asarray(tokens)))
    calls = _count_kernel_calls(monkeypatch)
    batch = Batch(tokens=torch.from_numpy(tokens).long(), labels=torch.from_numpy(labels).long())
    got, aux = mt.forward(params_t, batch)
    assert got.shape == want.shape and got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    attn_free = cfg.family == "ssm"
    assert calls == {"flash": 0 if attn_free else cfg.n_layers,
                     "scan": cfg.n_layers if attn_free else 0}
    loss_j = jax.jit(mj.train_loss)(params_j, JaxBatch(tokens=jnp.asarray(tokens),
                                                       labels=jnp.asarray(labels)))
    np.testing.assert_allclose(float(mt.train_loss(params_t, batch)), float(loss_j), atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_and_own_forward(arch):
    mj, mt, params_j, params_t = _pair(arch)
    cfg = mt.cfg
    b = 2
    steps = 136 if cfg.alt_local_global else 12  # gemma2: the local ring wraps at 128
    cache_len = 144 if cfg.alt_local_global else 16
    tokens = _tokens(cfg, b, steps, seed=2)
    cj, ct = mj.init_cache(b, cache_len), mt.init_cache(b, cache_len)
    assert [p for p, _ in _leaves(cj)] == [p for p, _ in _leaves(ct)]
    step_j = jax.jit(mj.decode_step)
    full, _ = mt.forward(params_t, Batch(tokens=torch.from_numpy(tokens).long()))
    for t in range(steps):
        pos = np.full((b,), t, np.int32)
        lj, cj = step_j(params_j, jnp.asarray(tokens[:, t:t + 1]), jnp.asarray(pos), cj)
        lt, ct = mt.decode_step(params_t, torch.from_numpy(tokens[:, t:t + 1]).long(),
                                torch.from_numpy(pos).long(), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, err_msg=f"step {t}")
        err = float((lt[:, 0, :cfg.vocab] - full[:, t, :cfg.vocab]).abs().max())
        assert err < 5e-2, f"step {t}: decode vs forward {err}"
    for (path, w), (_, g) in zip(_leaves(cj), _leaves(ct)):
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=path)
