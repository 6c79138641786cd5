"""The port's models against the JAX package's ``Model``, on the CPU.

The JAX ``Model.init`` tree crosses to the port with ``convert.from_numpy``
leaf for leaf (stacked layer axis, nested ``embed/table``, bf16 as raw
bits); then both run the same tokens (and, for whisper-tiny and
paligemma-3b, the same seeded ``encoder_frames`` or ``patch_embeddings``).
On the f32 smoke variants of smollm-360m, granite-3-2b, gemma2-2b (s above
its smoke window of 128, so the local layers' window bites),
falcon-mamba-7b, qwen3-moe-30b-a3b, arctic-480b, stablelm-12b, zamba2-7b
(hybrid: Mamba2 blocks and a shared attention block), whisper-tiny (audio:
an encoder and cross-attention) and paligemma-3b (vlm: a patch prefix):

* ``forward`` logits within 1e-4 of the JAX package's (f32; the attention
  and scan sum in another order than XLA's einsum and associative scan),
  the moe aux loss within 1e-6 and ``train_loss`` within 1e-5;
* ``decode_step`` logits within 1e-4 at every step and the caches within
  1e-5, gemma2's local ring wrapping past its window (and granite-3-2b's
  ``long_500k`` variant, every layer's ring of 128 wrapping over 160
  steps; its forward and gemma2's, smollm's and qwen3-moe's are held too);
  the moe archs at ``moe_capacity_factor=100``, as ``tests/test_models.py``
  decodes them (no drops, so the forward and the decode route every token
  alike);
* teacher-forced decode within 5e-2 of the port's own forward, the bound of
  ``tests/test_models.py::test_decode_matches_forward``; whisper's with the
  cross cache filled from the encoder output, as that test's
  ``_fill_whisper_cross`` fills it (ported here), paligemma's with no
  patches (pure gemma decoding, as the JAX package decodes it);
* the prefill forward reaches the flash-attention op once per dense or moe
  layer and per use of the hybrid's shared block, once per whisper encoder
  layer and twice per decoder layer (self and cross), twice per paligemma
  layer with patches (the prefix split), and the selective-scan op once per
  Mamba1 layer (never in the hybrid: Mamba2 is plain PyTorch);
* the hybrid's, whisper's and paligemma's loss and every gradient leaf
  match ``jax.grad`` (the hybrid's shared block's summed over its uses, over
  two super-blocks and a tail block); stablelm-12b at its own head dim 160,
  zamba2-7b at its 112 and paligemma-3b at its 256 with 8 / 1 heads (MQA)
  match the JAX forward on narrow widths (the smoke variants force 64);
* ``Model.init`` fills the stacked leaves in place with the draws that
  stacking per-layer trees would give.
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

ARCHS = ("smollm-360m", "granite-3-2b", "gemma2-2b", "falcon-mamba-7b", "qwen3-moe-30b-a3b",
         "arctic-480b", "stablelm-12b", "zamba2-7b", "whisper-tiny", "paligemma-3b")
SEQ = {"gemma2-2b": 160}  # above the smoke window of 128
KEY = jax.random.PRNGKey(0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _pair(arch, shape_name="", **overrides):
    cfg_j = jax_configs.get_arch(arch).smoke_variant().replace(**overrides)
    cfg_t = pt_configs.get_arch(arch).smoke_variant().replace(**overrides)
    mj = jax_build_model(cfg_j, shape_name)
    mt = build_model(cfg_t, shape_name, device="cpu")
    params_j = mj.init(KEY)
    return mj, mt, params_j, from_numpy(params_j, device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _frontend(cfg, b, seed=3):
    """The stubbed frontends' inputs, f32 numpy: whisper's frames, paligemma's
    patches, nothing for the other families."""
    g = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"encoder_frames": g.standard_normal((b, cfg.n_frames, cfg.d_model),
                                                    dtype=np.float32)}
    if cfg.family == "vlm":
        return {"patch_embeddings": g.standard_normal((b, cfg.n_patches, cfg.d_model),
                                                      dtype=np.float32)}
    return {}


def _batches(tokens, labels=None, **frontend):
    """The same inputs as a JAX and a port ``Batch``."""
    arrays = dict(tokens=tokens, labels=labels, **frontend)
    return (JaxBatch(**{k: None if a is None else jnp.asarray(a) for k, a in arrays.items()}),
            Batch(**{k: None if a is None else torch.from_numpy(a).long() if a.dtype == np.int32
                     else torch.from_numpy(a) for k, a in arrays.items()}))


def _fill_whisper_cross(model, params, frames, cache):
    """``tests/test_models.py::_fill_whisper_cross`` in the port: the encoder
    over ``frames`` (its own loop, bidirectional self-attention with rope),
    its final norm, then each decoder layer's cross K and V, as a prefill
    would leave them in the cache."""
    from repro_torch.models.layers import mlp, rms_norm
    from repro_torch.models.model import _layer

    cfg = model.cfg
    x = frames.to(model.dtype)
    b, f, _ = x.shape
    fpos = torch.arange(f).expand(b, f)
    for i in range(cfg.n_encoder_layers):
        block = _layer(params["enc_blocks"], i)
        x = x + pt_attn.attention(block["attn"], rms_norm(x, block["ln1"]), fpos, causal=False,
                                  rope_theta=cfg.rope_theta)
        x = x + mlp(block["mlp"], rms_norm(x, block["ln2"]))
    enc = rms_norm(x, params["enc_final_norm"])
    cross = params["blocks"]["cross"]
    kc = torch.stack([pt_attn.project_heads(enc, w) for w in cross["wk"]])
    vc = torch.stack([pt_attn.project_heads(enc, w) for w in cross["wv"]])
    return dict(cache, cross_k=kc.to(cache["cross_k"].dtype),
                cross_v=vc.to(cache["cross_v"].dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    want, got = jax_configs.get_arch(arch), pt_configs.get_arch(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.smoke_variant()) == dataclasses.asdict(want.smoke_variant())
    assert (got.d_inner, got.dt_rank, got.resolved_head_dim) == \
        (want.d_inner, want.dt_rank, want.resolved_head_dim)


def test_registry_holds_the_ported_archs():
    """The port's registry is the JAX package's: every arch is ported."""
    assert pt_configs.list_archs() == jax_configs.list_archs() == sorted(ARCHS)
    assert set(pt_configs.INPUT_SHAPES) == set(jax_configs.INPUT_SHAPES)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_jax(arch):
    mj, mt, params_j, _ = _pair(arch)
    got = dict(_leaves(mt.init(torch.Generator().manual_seed(0))))
    want = dict(_leaves(params_j))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == w.dtype.name, path
        if path.rsplit("/", 1)[-1] in ("ln", "ln1", "ln2", "ln_cross", "final_norm",
                                       "enc_final_norm", "dt_bias", "D"):
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


def _kernel_calls(cfg):
    """The flash and scan calls a prefill forward makes: one flash call a
    dense or moe layer, a use of the hybrid's shared block or a whisper
    encoder layer, two a whisper decoder layer (self and cross) or a
    paligemma layer with patches (the prefix split); one scan call a Mamba1
    layer."""
    if cfg.family == "ssm":
        return {"flash": 0, "scan": cfg.n_layers}
    if cfg.family == "hybrid":
        return {"flash": cfg.n_layers // cfg.attn_every, "scan": 0}
    if cfg.family == "audio":
        return {"flash": cfg.n_encoder_layers + 2 * cfg.n_layers, "scan": 0}
    if cfg.family == "vlm":
        return {"flash": 2 * cfg.n_layers, "scan": 0}
    return {"flash": cfg.n_layers, "scan": 0}


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
                         + [(a, "long_500k") for a in ("smollm-360m", "qwen3-moe-30b-a3b",
                                                       "granite-3-2b", "gemma2-2b")])
def test_forward_matches_jax(monkeypatch, arch, shape_name):
    mj, mt, params_j, params_t = _pair(arch, shape_name)
    cfg = mt.cfg
    b, s = 2, SEQ.get(arch, 160 if shape_name else 48)
    tokens = _tokens(cfg, b, s)
    labels = _tokens(cfg, b, s, seed=1)
    frontend = _frontend(cfg, b)
    want, want_aux = jax.jit(mj.forward)(params_j, _batches(tokens, **frontend)[0])
    calls = _count_kernel_calls(monkeypatch)
    batch_j, batch = _batches(tokens, labels, **frontend)
    got, aux = mt.forward(params_t, batch)
    assert got.shape == want.shape and got.dtype == torch.float32
    if cfg.family == "moe":  # the layers' Switch losses averaged over layers, ~1 each
        assert 0.5 < float(aux) and abs(float(aux) - float(want_aux)) <= 1e-6
    else:
        assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert calls == _kernel_calls(cfg)
    loss_j = jax.jit(mj.train_loss)(params_j, batch_j)
    np.testing.assert_allclose(float(mt.train_loss(params_t, batch)), float(loss_j), atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_and_own_forward(arch):
    no_drops = {"moe_capacity_factor": 100.0} if "moe" in arch or "arctic" in arch else {}
    mj, mt, params_j, params_t = _pair(arch, **no_drops)
    cfg = mt.cfg
    b = 2
    steps = 136 if cfg.alt_local_global else 12  # gemma2: the local ring wraps at 128
    cache_len = 144 if cfg.alt_local_global else 16
    tokens = _tokens(cfg, b, steps, seed=2)
    cj, ct = mj.init_cache(b, cache_len), mt.init_cache(b, cache_len)
    assert [p for p, _ in _leaves(cj)] == [p for p, _ in _leaves(ct)]
    # whisper decodes against the encoder of its frames; paligemma decodes
    # with no patches, as the JAX package does
    frontend = _frontend(cfg, b) if cfg.family == "audio" else {}
    batch_j, batch_t = _batches(tokens, **frontend)
    if cfg.family == "audio":  # each package's cache filled by its own helper
        from test_models import _fill_whisper_cross as jax_fill_whisper_cross

        cj = jax_fill_whisper_cross(mj, params_j, batch_j, cj)
        ct = _fill_whisper_cross(mt, params_t, batch_t.encoder_frames, ct)
        for n in ("cross_k", "cross_v"):
            np.testing.assert_allclose(ct[n].numpy(), np.asarray(cj[n]), atol=1e-5, err_msg=n)
    step_j = jax.jit(mj.decode_step)
    full, _ = mt.forward(params_t, batch_t)
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


def test_long_context_ring_decode_matches_jax_and_own_forward():
    """granite-3-2b's ``long_500k`` variant at smoke size: every layer
    windowed (128) and its cache a ring of ``min(cache_len, window)``. Over
    160 steps the ring wraps, and the decode must still match the JAX
    package's ``decode_step`` and the port's own windowed forward."""
    mj, mt, params_j, params_t = _pair("granite-3-2b", "long_500k")
    cfg = mt.cfg
    b, steps, cache_len = 2, 160, 160
    window = cfg.sliding_window
    assert mt.long_context and window == 128
    tokens = _tokens(cfg, b, steps, seed=4)
    cj, ct = mj.init_cache(b, cache_len), mt.init_cache(b, cache_len)
    assert ct["kv"]["k"].shape[2] == window and cj["kv"]["k"].shape[2] == window
    step_j = jax.jit(mj.decode_step)
    full, _ = mt.forward(params_t, _batches(tokens)[1])
    for t in range(steps):
        pos = np.full((b,), t, np.int32)
        lj, cj = step_j(params_j, jnp.asarray(tokens[:, t:t + 1]), jnp.asarray(pos), cj)
        lt, ct = mt.decode_step(params_t, torch.from_numpy(tokens[:, t:t + 1]).long(),
                                torch.from_numpy(pos).long(), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, err_msg=f"step {t}")
        err = float((lt[:, 0, :cfg.vocab] - full[:, t, :cfg.vocab]).abs().max())
        assert err < 5e-2, f"step {t}: decode vs forward {err}"
    for (path, w), (_, g) in zip(_leaves(cj), _leaves(ct)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=path)
    # past the window the ring is the last 128 keys, not the first: the
    # windowed forward differs from full attention there
    dense = build_model(cfg, device="cpu")
    full_attn, _ = dense.forward(params_t, _batches(tokens)[1])
    assert float((full_attn[:, steps - 1] - full[:, steps - 1]).abs().max()) > 1e-3


def test_whisper_decode_matches_forward_with_the_cross_cache_filled():
    """``tests/test_models.py::test_decode_matches_forward`` for whisper-tiny
    in the port, at its sizes (b 2, s 24, cache 64): teacher-forced decode
    with the cross cache filled from the encoder output reproduces the
    forward within 5e-2; the filled cache equals the decoder layers' own
    cross projections of ``Model.encode``. A decode step reads the cross
    cache (an unfilled one gives other logits) and passes it through."""
    cfg = pt_configs.get_arch("whisper-tiny").smoke_variant()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    b, s = 2, 24
    tokens = torch.from_numpy(_tokens(cfg, b, s, seed=4)).long()
    frames = torch.from_numpy(_frontend(cfg, b, seed=5)["encoder_frames"])
    full, _ = model.forward(params, Batch(tokens=tokens, encoder_frames=frames))
    cache = _fill_whisper_cross(model, params, frames, model.init_cache(b, 64))
    enc = model.encode(params, frames)
    torch.testing.assert_close(cache["cross_k"][1], pt_attn.project_heads(
        enc, params["blocks"]["cross"]["wk"][1]), atol=1e-6, rtol=0)
    pos0 = torch.zeros(b, dtype=torch.long)
    empty, _ = model.decode_step(params, tokens[:, :1], pos0, model.init_cache(b, 64))
    assert float((empty[:, 0] - full[:, 0]).abs().max()) > 5e-2
    errs = []
    for t in range(s):
        pos = torch.full((b,), t, dtype=torch.long)
        logits, new = model.decode_step(params, tokens[:, t:t + 1], pos, cache)
        assert new["cross_k"] is cache["cross_k"] and new["cross_v"] is cache["cross_v"]
        cache = new
        errs.append(float((logits[:, 0, :cfg.vocab] - full[:, t, :cfg.vocab]).abs().max()))
    assert max(errs) < 5e-2, f"max abs logit err {max(errs)}"


@pytest.mark.parametrize("arch", ("gemma2-2b", "qwen3-moe-30b-a3b"))
def test_init_fills_stacked_leaves_with_the_stacked_draws(monkeypatch, arch):
    """``_stack_layers`` draws block after block, as stacking a list of
    per-layer trees does, so the in-place init gives the same values."""
    from repro_torch.models import model as pt_model

    mt = build_model(pt_configs.get_arch(arch).smoke_variant().replace(n_layers=4),
                     device="cpu")
    got = mt.init(torch.Generator().manual_seed(7))
    calls = []

    def stacked(n, make_block):
        calls.append(n)
        return pt_model._stack([make_block() for _ in range(n)])

    monkeypatch.setattr(pt_model, "_stack_layers", stacked)
    want = mt.init(torch.Generator().manual_seed(7))
    assert calls and all(n == (2 if mt.cfg.alt_local_global else 4) for n in calls)
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        assert torch.equal(g, w), path
    one = pt_model._stack_layers(1, lambda: {"w": torch.ones(3)})
    assert one["w"].shape == (1, 3)


# qwen3-moe-30b-a3b at 1 layer, f32, one row of 512 tokens (the group size
# and capacity of its 2048-token rows: 64 and 5). Each case keeps one of the
# two widths that hold most of the parameters at full size and narrows the
# other, so a case holds ~50 M f32 parameters: full d_model (2048) with a
# narrow vocab, and the full vocab (151936) with a narrow d_model. Both keep
# the full 128 experts, top 8, capacity factor and 32 / 4 heads of 128.
QWEN3_WIDTHS = {"d_model 2048": dict(vocab=4096), "vocab 151936": dict(d_model=256)}


@pytest.mark.parametrize("width", sorted(QWEN3_WIDTHS))
def test_qwen3_moe_loss_and_grads_match_jax_at_full_routing_width(width):
    """``train_loss`` within 1e-5 relative and every gradient leaf within
    1e-4 of its max |g| of the JAX package's, on the same converted params."""
    from repro_torch.models.moe import group_size

    cut = dict(n_layers=1, d_ff=32, dtype="float32", optimizer_dtype="float32", remat=False,
               **QWEN3_WIDTHS[width])
    cfg_j = jax_configs.get_arch("qwen3-moe-30b-a3b").replace(**cut)
    cfg_t = pt_configs.get_arch("qwen3-moe-30b-a3b").replace(**cut)
    assert (cfg_t.n_experts, cfg_t.top_k, cfg_t.n_heads, cfg_t.n_kv_heads) == (128, 8, 32, 4)
    s = 512
    assert group_size(s, cfg_t.n_experts, cfg_t.top_k, cfg_t.moe_capacity_factor) == \
        group_size(2048, cfg_t.n_experts, cfg_t.top_k, cfg_t.moe_capacity_factor) == (64, 5)
    mj, mt = jax_build_model(cfg_j), build_model(cfg_t, device="cpu")
    params_j = mj.init(KEY)
    tokens, labels = _tokens(cfg_t, 1, s), _tokens(cfg_t, 1, s, seed=1)
    batch_j = JaxBatch(tokens=jnp.asarray(tokens), labels=jnp.asarray(labels))
    loss_j, grads_j = jax.jit(jax.value_and_grad(mj.train_loss))(params_j, batch_j)
    params_t = from_numpy(params_j, device="cpu")
    del params_j
    leaves = [t.requires_grad_(True) for _, t in _leaves(params_t)]
    loss_t = mt.train_loss(params_t, Batch(tokens=torch.from_numpy(tokens).long(),
                                           labels=torch.from_numpy(labels).long()))
    grads_t = torch.autograd.grad(loss_t, leaves)
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = list(_leaves(grads_j))
    assert [p for p, _ in want] == [p for p, _ in _leaves(params_t)]
    for (path, w), g in zip(want, grads_t):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), (path, err, float(np.abs(w).max()))


def _loss_and_grads(cfg_j, cfg_t, s=48):
    """``train_loss`` and every gradient leaf of both packages on the same
    converted params, with masked labels (and the frontend's inputs)."""
    mj, mt = jax_build_model(cfg_j), build_model(cfg_t, device="cpu")
    params_j = mj.init(KEY)
    tokens, labels = _tokens(cfg_t, 2, s), _tokens(cfg_t, 2, s, seed=1)
    labels[1, :7] = -1
    batch_j, batch_t = _batches(tokens, labels, **_frontend(cfg_t, 2))
    loss_j, grads_j = jax.jit(jax.value_and_grad(mj.train_loss))(params_j, batch_j)
    params_t = from_numpy(params_j, device="cpu")
    leaves = [t.requires_grad_(True) for _, t in _leaves(params_t)]
    loss_t = mt.train_loss(params_t, batch_t)
    grads_t = torch.autograd.grad(loss_t, leaves)
    return (float(loss_t.detach()), float(loss_j), dict(zip([p for p, _ in _leaves(params_t)],
                                                             grads_t)),
            dict(_leaves(jax.device_get(grads_j))))


def test_hybrid_loss_and_grads_match_jax_over_two_super_blocks_and_a_tail():
    """zamba2-7b's smoke variant at 5 layers, attention every 2: two
    super-blocks of one Mamba2 block and the shared block, then a tail
    block. Loss within 1e-5 relative and every gradient leaf within 1e-4 of
    its max |g| of ``jax.grad``'s; the shared block's gradient is the sum
    over its two uses (a port that kept one copy per use would split it)."""
    overrides = dict(n_layers=5, attn_every=2)
    cfg_j = jax_configs.get_arch("zamba2-7b").smoke_variant().replace(**overrides)
    cfg_t = pt_configs.get_arch("zamba2-7b").smoke_variant().replace(**overrides)
    mt = build_model(cfg_t, device="cpu")
    assert (mt.n_super, mt.mamba_per_super, mt.n_tail) == (2, 1, 1)
    loss_t, loss_j, got, want = _loss_and_grads(cfg_j, cfg_t)
    assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j)
    assert sorted(got) == sorted(want) and "/shared_attn/attn/wq" in got
    assert got["/mamba_blocks/body/wx"].shape[:2] == (2, 1) and "/tail_blocks/body/wx" in got
    for path, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(got[path].numpy() - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()), (path, err, float(np.abs(w).max()))


@pytest.mark.parametrize("arch", ("whisper-tiny", "paligemma-3b"))
def test_frontend_families_loss_and_grads_match_jax(arch):
    """whisper's and paligemma's smoke variants, with seeded frames or
    patches and masked labels: the loss within 1e-5 relative and every
    gradient leaf within 1e-4 of its max |g| of ``jax.grad``'s (whisper's
    encoder leaves take their gradient through the cross-attention's K and
    V, paligemma's through the two calls of the prefix split)."""
    cfg_j = jax_configs.get_arch(arch).smoke_variant()
    cfg_t = pt_configs.get_arch(arch).smoke_variant()
    loss_t, loss_j, got, want = _loss_and_grads(cfg_j, cfg_t)
    assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j)
    assert sorted(got) == sorted(want)
    assert ("/enc_blocks/attn/wq" in got) == (arch == "whisper-tiny")
    for path, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(got[path].numpy() - w).max())
        assert float(np.abs(w).max()) > 0, path
        assert err <= 1e-4 * float(np.abs(w).max()), (path, err, float(np.abs(w).max()))


# the configs' own head shapes beyond head dim: paligemma-3b's 8 / 1 (MQA)
OWN_HEADS = {"paligemma-3b": dict(n_heads=8, n_kv_heads=1)}


@pytest.mark.parametrize("arch,head_dim", [("stablelm-12b", 160), ("zamba2-7b", 112),
                                           ("paligemma-3b", 256)])
def test_forward_and_loss_at_the_configs_own_head_dim(monkeypatch, arch, head_dim):
    """The smoke variants force head dim 64; here each arch keeps its own
    (stablelm's GQA 4 / 2 at 160, zamba2's MHA at 112, paligemma's MQA 8 / 1
    at 256 with its patch prefix) on narrow widths: logits within 1e-4 and
    the loss within 1e-5 of the JAX model's."""
    mj, mt, params_j, params_t = _pair(arch, head_dim=head_dim, **OWN_HEADS.get(arch, {}))
    cfg = mt.cfg
    assert cfg.resolved_head_dim == head_dim
    tokens, labels = _tokens(cfg, 2, 40), _tokens(cfg, 2, 40, seed=1)
    batch_j, batch = _batches(tokens, labels, **_frontend(cfg, 2))
    want, _ = jax.jit(mj.forward)(params_j, batch_j)
    calls = _count_kernel_calls(monkeypatch)
    got, _ = mt.forward(params_t, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert calls == _kernel_calls(cfg)
    loss_j = jax.jit(mj.train_loss)(params_j, batch_j)
    np.testing.assert_allclose(float(mt.train_loss(params_t, batch)), float(loss_j), atol=1e-5)
