"""The port's attention against the JAX package's, on the CPU.

* The plain flash attention (``repro_torch.kernels.attention``) against the
  Pallas kernel in interpret mode and the jnp oracle, on the cases of
  ``tests/test_kernels.py`` plus GQA cases (the JAX side expands kv with
  ``jnp.repeat``). Tolerances are those of ``tests/test_kernels.py``: 2e-5
  in f32, 2e-2 in bf16 (the sum order differs).
* ``models.attention.attention`` and ``decode_attention`` against
  ``repro.models.attention`` on the same weights: within 1e-5 in f32.
* Routing: self-attention over arange positions takes the flash op (one
  call); a prefix with no window takes it twice (a non-causal call over the
  prefix, a causal one over everything); cross-attention with no key
  positions takes one non-causal call with s_q != s_kv, whatever ``causal``
  says; a prefix with a window and other positions take the masked einsum.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.attention.flash import flash_attention as jax_flash  # noqa: E402
from repro.kernels.attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro_torch.kernels.attention.ops import flash_attention_op  # noqa: E402
from repro_torch.kernels.attention.ref import (  # noqa: E402
    BF16_UNITS_TOL,
    attention_ref,
    rounding_units,
)
from repro_torch.models import attention as pt_attn  # noqa: E402

CASES = [  # b, s, h, kv, hd, causal, window, softcap
    (2, 256, 4, 4, 64, True, 0, 0.0),
    (1, 512, 2, 2, 128, True, 0, 0.0),
    (2, 256, 3, 3, 64, True, 128, 0.0),  # sliding window
    (1, 256, 4, 4, 64, False, 0, 0.0),  # bidirectional (encoder)
    (1, 256, 2, 2, 64, True, 0, 50.0),  # gemma2 softcap
    (2, 384, 5, 5, 32, True, 256, 30.0),  # window + softcap, odd sizes
    (2, 256, 6, 2, 64, True, 0, 0.0),  # GQA, 3 q heads per kv head (smollm's ratio)
    (1, 256, 4, 2, 256, True, 128, 50.0),  # GQA at gemma2's head dim, window + softcap
    (2, 256, 4, 4, 112, True, 0, 0.0),  # zamba2's head dim, MHA
    (1, 256, 4, 1, 160, True, 128, 0.0),  # stablelm-12b's head dim, GQA 4 / 1, window
]


def _qkv(b, s, h, kv, hd, seed=0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((b, s, h, hd), dtype=np.float32),
            g.standard_normal((b, s, kv, hd), dtype=np.float32),
            g.standard_normal((b, s, kv, hd), dtype=np.float32))


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,softcap", CASES)
def test_plain_flash_matches_pallas_and_oracle(b, s, h, kv, hd, causal, window, softcap,
                                               dtype, atol):
    q, k, v = _qkv(b, s, h, kv, hd)
    jd = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    jk, jv = jnp.repeat(jk, h // kv, axis=2), jnp.repeat(jv, h // kv, axis=2)
    kw = dict(causal=causal, sliding_window=window, softcap=softcap)
    pallas = np.asarray(jax_flash(jq, jk, jv, interpret=True, **kw), np.float32)
    oracle = np.asarray(jax_attention_ref(jq, jk, jv, **kw), np.float32)
    td = getattr(torch, dtype)
    # the same rounded inputs as the JAX side
    tq, tk, tv = (torch.tensor(np.asarray(jnp.asarray(a, jd), np.float32)).to(td)
                  for a in (q, k, v))
    out = flash_attention_op(tq, tk, tv, **kw)
    assert out.dtype == td and out.shape == (b, s, h, hd)
    out = out.float().numpy()
    np.testing.assert_allclose(out, pallas, atol=atol)
    np.testing.assert_allclose(out, oracle, atol=atol)


def test_plain_flash_takes_any_length():
    """The kernel masks ragged tiles, so its plain version takes any s; at
    s = 200 it equals the first 200 rows of a longer causal run."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 256, 4, 2, 64, seed=3))
    full = attention_ref(q, k, v, causal=True)
    part = attention_ref(q[:, :200], k[:, :200], v[:, :200], causal=True)
    torch.testing.assert_close(part, full[:, :200], atol=1e-6, rtol=0)


def _params(d, h, kv, hd, seed=1):
    g = np.random.default_rng(seed)
    shapes = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd), "wo": (h, hd, d)}
    return {n: (g.standard_normal(sh) * 0.05).astype(np.float32) for n, sh in shapes.items()}


def _both(p):
    return ({n: jnp.asarray(a) for n, a in p.items()},
            {n: torch.from_numpy(a) for n, a in p.items()})


ATTN_CASES = [  # h, kv, causal, window, softcap, prefix_len, positions
    (4, 2, True, 0, 0.0, 0, "arange"),
    (4, 4, True, 16, 0.0, 0, "arange"),
    (4, 2, True, 16, 30.0, 0, "arange"),
    (4, 2, False, 0, 0.0, 0, "arange"),
    (4, 2, True, 0, 0.0, 8, "arange"),  # vlm prefix: two flash calls
    (8, 1, True, 0, 0.0, 13, "arange"),  # paligemma's MQA, a prefix of no tile's size
    (4, 2, True, 16, 0.0, 8, "arange"),  # a prefix with a window: the einsum route
    (4, 2, True, 0, 0.0, 0, "offset"),  # positions 5..: the einsum route
    (4, 2, True, 8, 50.0, 0, "offset"),
]


@pytest.mark.parametrize("h,kv,causal,window,softcap,prefix,pos", ATTN_CASES)
def test_attention_matches_jax(monkeypatch, h, kv, causal, window, softcap, prefix, pos):
    b, s, d, hd = 2, 40, 32, 16 * 2
    p = _params(d, h, kv, hd)
    x = np.random.default_rng(2).standard_normal((b, s, d)).astype(np.float32)
    positions = np.broadcast_to(np.arange(s) + (5 if pos == "offset" else 0), (b, s))
    kw = dict(causal=causal, sliding_window=window, softcap=softcap, prefix_len=prefix)
    jp, tp = _both(p)
    want = np.asarray(jax_attn.attention(jp, jnp.asarray(x), jnp.asarray(positions), **kw))

    calls = []
    real = pt_attn.flash_attention_op
    monkeypatch.setattr(pt_attn, "flash_attention_op",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    got = pt_attn.attention(tp, torch.from_numpy(x), torch.from_numpy(positions.copy()), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if pos != "arange" or (prefix and window):
        assert calls == []
    elif prefix:  # the prefix block non-causal, then everything causal
        assert calls == [dict(causal=False, sliding_window=0, softcap=softcap),
                         dict(causal=True, sliding_window=0, softcap=softcap)]
    else:
        assert calls == [dict(causal=causal, sliding_window=window, softcap=softcap)]


@pytest.mark.parametrize("s,causal", [(12, False), (1, False), (12, True)])
def test_cross_attention_matches_jax(monkeypatch, s, causal):
    """whisper's cross-attention (s = 12) and its decode step (s = 1): with
    no key positions every key is visible, causal or not, as in the JAX
    package; one non-causal flash call, s_q != s_kv."""
    b, f, d, h, hd = 2, 20, 32, 4, 16
    p = _params(d, h, h, hd, seed=4)
    g = np.random.default_rng(5)
    x = g.standard_normal((b, s, d)).astype(np.float32)
    kc = g.standard_normal((b, f, h, hd)).astype(np.float32)
    vc = g.standard_normal((b, f, h, hd)).astype(np.float32)
    positions = np.broadcast_to(np.arange(s), (b, s)).copy()
    jp, tp = _both(p)
    want = jax_attn.attention(jp, jnp.asarray(x), jnp.asarray(positions), causal=causal,
                              use_rope=False, kv_override=(jnp.asarray(kc), jnp.asarray(vc)),
                              kv_positions=None)
    calls = []
    real = pt_attn.flash_attention_op
    monkeypatch.setattr(pt_attn, "flash_attention_op",
                        lambda q, k, v, **kw: calls.append((q.shape[1], k.shape[1], kw))
                        or real(q, k, v, **kw))
    got = pt_attn.attention(tp, torch.from_numpy(x), torch.from_numpy(positions), causal=causal,
                            use_rope=False,
                            kv_override=(torch.from_numpy(kc), torch.from_numpy(vc)),
                            kv_positions=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert calls == [(s, f, dict(causal=False, sliding_window=0, softcap=0.0))]


@pytest.mark.parametrize("window,cache_len,positions", [
    (0, 32, [0, 3]),
    (0, 32, [31, 17]),
    (8, 8, [2, 5]),  # ring not yet wrapped
    (8, 8, [8, 21]),  # wrapped: every slot valid, slot = position % 8
    (0, 16, [16, 3]),  # a slot past the cache is not written
])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_decode_attention_matches_jax(window, cache_len, positions, softcap):
    b, d, h, kv, hd = 2, 32, 4, 2, 16
    p = _params(d, h, kv, hd, seed=6)
    g = np.random.default_rng(7)
    x = g.standard_normal((b, 1, d)).astype(np.float32)
    cache = {n: g.standard_normal((b, cache_len, kv, hd)).astype(np.float32) for n in "kv"}
    pos = np.asarray(positions, np.int32)
    kw = dict(sliding_window=window, softcap=softcap)
    jp, tp = _both(p)
    want, want_c = jax_attn.decode_attention(
        jp, jnp.asarray(x), jnp.asarray(pos), {n: jnp.asarray(a) for n, a in cache.items()}, **kw)
    got, got_c = pt_attn.decode_attention(
        tp, torch.from_numpy(x), torch.from_numpy(pos).long(),
        {n: torch.from_numpy(a) for n, a in cache.items()}, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    written = np.zeros((b, cache_len), bool)
    for i, t in enumerate(positions):
        slot = t % cache_len if window else t
        if slot < cache_len:
            written[i, slot] = True
    for n in "kv":
        # untouched slots are copied exactly; the new entry differs by RoPE's rounding
        np.testing.assert_array_equal(got_c[n].numpy()[~written], cache[n][~written])
        np.testing.assert_allclose(got_c[n].numpy(), np.asarray(want_c[n]), atol=1e-6)


def test_init_kv_cache_matches_jax():
    want = jax_attn.init_kv_cache(2, 16, 3, 32, jnp.bfloat16)
    got = pt_attn.init_kv_cache(2, 16, 3, 32, torch.bfloat16, device="cpu")
    for n in "kv":
        assert tuple(got[n].shape) == want[n].shape and got[n].dtype == torch.bfloat16
        assert not got[n].any()


def test_flash_op_rejects_other_devices():
    q = torch.zeros(1, 4, 2, 32, device="meta")
    with pytest.raises(ValueError):
        flash_attention_op(q, q, q)


def test_tma_layout_check_takes_aligned_views_and_rejects_misaligned():
    """The bf16 wrapper's TMA rule (16-byte base, (b, s, h) strides in
    multiples of 8 elements), rehearsed on CPU tensors: contiguous tensors and
    a fused projection's views pass; a 2-byte offset or a head stride of 68
    elements raises; an extent-1 dim's stride is not checked."""
    from repro_torch.kernels.attention.flash import _check_tma_layout

    qkv = torch.zeros(2, 130, 12, 64, dtype=torch.bfloat16)
    _check_tma_layout(qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:])
    _check_tma_layout(torch.zeros(1, 1, 1, 32, dtype=torch.bfloat16).as_strided(
        (1, 1, 1, 32), (3, 5, 7, 1)))
    flat = torch.zeros(8 * 4 * 64 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        _check_tma_layout(flat[1:1 + 8 * 4 * 64].view(1, 8, 4, 64))
    with pytest.raises(ValueError):
        _check_tma_layout(torch.zeros(1, 8, 4, 68, dtype=torch.bfloat16)[..., :64])



@pytest.mark.parametrize("causal,window,softcap,q_scale", [
    (True, 0, 0.0, 1.0), (True, 512, 50.0, 1.0), (True, 512, 50.0, 25.0), (False, 0, 0.0, 1.0)])
def test_rounding_units_pass_rounding_and_catch_a_dropped_key_tile(causal, window, softcap,
                                                                   q_scale):
    """The measure that holds the bf16 kernel on the card, rehearsed on the
    CPU: the f32 attention rounded to bf16 reads at most 1 unit; the same
    attention with one 64-key tile dropped from the last 64 rows (the tile's
    keys add to neither the sum nor the output, as when a kernel skips a
    visible tile) reads far above BF16_UNITS_TOL."""
    from repro_torch.kernels.attention.ref import _probs

    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1024, 2, 1, 64, seed=5))
    q, k, v = (q * q_scale).bfloat16(), k.bfloat16(), v.bfloat16()
    kw = dict(causal=causal, sliding_window=window, softcap=softcap)
    exact = attention_ref(q.float(), k.float(), v.float(), **kw)
    assert rounding_units(exact.bfloat16(), q, k, v, **kw) <= 1.0
    p, vf = _probs(q, k, v, causal, window, softcap)
    p[:, :, 960:, 704:768] = 0.0  # inside every late row's window
    p /= p.sum(-1, keepdim=True)
    faulty = torch.einsum("bhqk,bkhd->bqhd", p, vf).bfloat16()
    assert rounding_units(faulty, q, k, v, **kw) > 10 * BF16_UNITS_TOL


# -- the backward: attention_bwd_ref and the autograd Function (P3) -------------

from repro_torch.kernels.attention.ops import FlashAttention  # noqa: E402
from repro_torch.kernels.attention.ref import (  # noqa: E402
    attention_bwd_ref,
    attention_lse_ref,
)

BWD_CASES = [  # b, s, h, kv, hd, causal, window, softcap
    (2, 96, 4, 4, 32, True, 0, 0.0),
    (1, 128, 6, 2, 64, True, 0, 0.0),  # GQA 3:1 (smollm's ratio)
    (2, 100, 3, 3, 32, True, 40, 0.0),  # sliding window
    (1, 90, 2, 2, 64, True, 0, 30.0),  # softcap
    (1, 120, 4, 2, 32, True, 48, 50.0),  # GQA, window and softcap (gemma2's local layer)
    (1, 80, 4, 1, 32, False, 0, 0.0),  # bidirectional, one kv head
]


def _grads_close(got, want, rel):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, dtype=np.float64)
        g = g.detach().double().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape, name
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= rel * scale, f"{name}: {err} > {rel} x {scale}"


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,softcap", BWD_CASES)
def test_attention_bwd_ref_matches_autograd_and_jax_vjp(b, s, h, kv, hd, causal, window,
                                                        softcap):
    """attention_bwd_ref, step by step, against autograd of attention_ref and
    against jax.vjp of the JAX package's einsum attention (kv expanded with
    jnp.repeat, so its dK and dV sum over each kv head's query heads):
    within 1e-5 of each gradient's max |g| in f32."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, s, h, kv, hd, seed=7))
    do = torch.from_numpy(np.random.default_rng(8).standard_normal((b, s, h, hd),
                                                                   dtype=np.float32))
    kw = dict(causal=causal, sliding_window=window, softcap=softcap)
    out, lse = attention_lse_ref(q, k, v, **kw)
    assert float((out - attention_ref(q, k, v, **kw)).abs().max()) <= 1e-6
    got = attention_bwd_ref(q, k, v, out, lse, do, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(attention_ref(*leaves, **kw), leaves, do)
    _grads_close(got, auto, 1e-5)
    g = h // kv

    def jax_attention(jq, jk, jv):
        return jax_attention_ref(jq, jnp.repeat(jk, g, axis=2), jnp.repeat(jv, g, axis=2), **kw)

    _, vjp = jax.vjp(jax_attention, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    _grads_close(got, vjp(jnp.asarray(do.numpy())), 1e-5)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,softcap", BWD_CASES[1::2])
def test_flash_op_is_the_autograd_function_on_cpu(b, s, h, kv, hd, causal, window, softcap):
    """P3, on the CPU: with a gradient to take the op goes through
    FlashAttention (forward with the LSE, backward attention_bwd_ref) and
    its gradients equal autograd's of attention_ref; without one it returns
    attention_ref's output with no graph."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(b, s, h, kv, hd, seed=9))
    kw = dict(causal=causal, sliding_window=window, softcap=softcap)
    out = flash_attention_op(q, k, v, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert out.grad_fn.__class__.__qualname__.startswith(FlashAttention.__name__)
    want_out = attention_ref(q, k, v, **kw)
    assert float((out - want_out).abs().max()) <= 1e-6
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(want_out, (q, k, v), do)
    _grads_close(got, want, 1e-5)
    with torch.no_grad():
        assert flash_attention_op(q, k, v, **kw).grad_fn is None
    plain = flash_attention_op(q.detach(), k.detach(), v.detach(), **kw)
    assert plain.grad_fn is None and torch.equal(plain, want_out.detach())


def test_lse_ref_is_the_logsumexp_of_the_masked_scores():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 2, 1, 32, seed=3))
    _, lse = attention_lse_ref(q, k, v, causal=True, sliding_window=16, softcap=20.0)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.expand(1, 64, 2, 32)) / 32 ** 0.5
    s = 20.0 * torch.tanh(s / 20.0)
    i = torch.arange(64)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 16)
    want = torch.logsumexp(s.masked_fill(~mask, -float("inf")), dim=-1)
    assert float((lse - want).abs().max()) <= 1e-5
