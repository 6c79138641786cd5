"""The port's selective scan and Mamba1 block against the JAX package's, on the CPU.

* The plain scan (``repro_torch.kernels.scan``) against the Pallas kernel
  in interpret mode and the jnp oracle, on the cases of
  ``tests/test_kernels.py``, with its tolerances: 1e-4 in f32, 5e-2 when x
  (and so y) is bf16.
* ``out_dtype=float32`` with a bf16 x: the Mamba1 block's call, whose y
  skips the bf16 rounding the TPU kernel applies (within 1e-4 of the f32
  oracle on the same rounded x).
* The kernel's decomposition (``selective_scan_blocked``: chunks, per-thread
  serial segments, a scan of (a, b) pairs carried across chunks) against the Pallas
  kernel, the jnp oracle and the plain scan, with ragged lengths: 1e-4.
* ``models.mamba``'s block, conv and decode step against
  ``repro.models.mamba`` on the same weights (the block's scan is the port's
  stand-in for ``chunked_selective_scan``): within 1e-5 in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.scan.mamba_scan import mamba_selective_scan  # noqa: E402
from repro.kernels.scan.ref import selective_scan_ref as jax_scan_ref  # noqa: E402
from repro.models import mamba as jax_mamba  # noqa: E402
from repro_torch.kernels.scan.ops import selective_scan_op  # noqa: E402
from repro_torch.kernels.scan.ref import selective_scan_blocked, selective_scan_ref  # noqa: E402
from repro_torch.models import mamba as pt_mamba  # noqa: E402


def _inputs(b, s, di, n, seed=0):
    g = np.random.default_rng(seed)
    dt = np.log1p(np.exp(g.standard_normal((b, s, di)))).astype(np.float32)
    return dict(dt=dt,
                Bm=g.standard_normal((b, s, n), dtype=np.float32),
                Cm=g.standard_normal((b, s, n), dtype=np.float32),
                x=g.standard_normal((b, s, di), dtype=np.float32),
                A_log=np.log(np.abs(g.standard_normal((di, n))) + 0.5).astype(np.float32),
                D=g.standard_normal((di,), dtype=np.float32))


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("b,s,di,n,bd,chunk", [
    (2, 64, 128, 16, 64, 16),
    (1, 96, 64, 8, 32, 32),
    (3, 32, 256, 4, 128, 8),
])
def test_plain_scan_matches_pallas_and_oracle(b, s, di, n, bd, chunk, dtype, atol):
    a = _inputs(b, s, di, n)
    jd = jnp.dtype(dtype)
    j = {k: jnp.asarray(v, jd if k == "x" else jnp.float32) for k, v in a.items()}
    args = [j[k] for k in ("dt", "Bm", "Cm", "x", "A_log", "D")]
    py, ph = mamba_selective_scan(*args, block_d=bd, chunk=chunk, interpret=True)
    ry, rh = jax_scan_ref(*args)
    t = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in j.items()}
    t["x"] = t["x"].to(getattr(torch, dtype))
    y, h = selective_scan_op(*[t[k] for k in ("dt", "Bm", "Cm", "x", "A_log", "D")])
    assert y.dtype == t["x"].dtype and h.dtype == torch.float32 and h.shape == (b, di, n)
    for want_y, want_h in ((py, ph), (ry, rh)):
        np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y, np.float32), atol=atol)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=atol)


def test_plain_scan_writes_f32_y_for_bf16_x():
    a = _inputs(2, 64, 128, 16, seed=1)
    xb = torch.from_numpy(a["x"]).to(torch.bfloat16)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    y, h = selective_scan_op(t["dt"], t["Bm"], t["Cm"], xb, t["A_log"], t["D"],
                             out_dtype=torch.float32)
    assert y.dtype == torch.float32
    ry, rh = jax_scan_ref(*[jnp.asarray(a[k]) for k in ("dt", "Bm", "Cm")],
                          jnp.asarray(xb.float().numpy()), jnp.asarray(a["A_log"]),
                          jnp.asarray(a["D"]))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=1e-4)


@pytest.mark.parametrize("b,s,di,n,items,segments", [
    (2, 96, 64, 8, 5, 4),  # 20-step chunks: 5, the last ragged
    (1, 75, 16, 16, 16, 4),  # the kernel's geometry: two 64-step chunks, ragged
    (2, 300, 8, 4, 16, 4),  # five chunks
    (1, 1, 8, 32, 16, 4),
    (3, 64, 24, 1, 3, 3),
])
def test_blocked_scan_decomposition_matches_jax(b, s, di, n, items, segments):
    a = _inputs(b, s, di, n, seed=s)
    j = [jnp.asarray(a[k]) for k in ("dt", "Bm", "Cm", "x", "A_log", "D")]
    t = [torch.from_numpy(a[k]) for k in ("dt", "Bm", "Cm", "x", "A_log", "D")]
    y, h = selective_scan_blocked(*t, items=items, segments=segments)
    wants = [jax_scan_ref(*j), selective_scan_ref(*t)]
    if s % 32 == 0:
        wants.append(mamba_selective_scan(*j, block_d=di // 2, chunk=32, interpret=True))
    for want_y, want_h in wants:
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y, np.float32), atol=1e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h, np.float32), atol=1e-4)


D_MODEL, D_INNER, N, RANK, WIDTH = 32, 64, 16, 2, 4


def _block_params(seed=2):
    g = np.random.default_rng(seed)
    shapes = {"wx": (D_MODEL, D_INNER), "wz": (D_MODEL, D_INNER), "conv_w": (WIDTH, D_INNER),
              "wdt_in": (D_INNER, RANK), "wB": (D_INNER, N), "wC": (D_INNER, N),
              "dt_proj": (RANK, D_INNER), "out_proj": (D_INNER, D_MODEL)}
    p = {k: (g.standard_normal(s) * 0.2).astype(np.float32) for k, s in shapes.items()}
    p["dt_bias"] = (g.standard_normal(D_INNER) * 0.1).astype(np.float32)
    p["A_log"] = np.log(np.broadcast_to(np.arange(1, N + 1, dtype=np.float32), (D_INNER, N)))
    p["D"] = np.ones(D_INNER, np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.tensor(v) for k, v in p.items()})


@pytest.mark.parametrize("s", [1, 7, 48])
def test_mamba1_forward_matches_jax(s):
    jp, tp = _block_params()
    x = np.random.default_rng(3).standard_normal((2, s, D_MODEL)).astype(np.float32)
    want = jax_mamba.mamba1_forward(jp, jnp.asarray(x), N, RANK, chunk=16)
    got = pt_mamba.mamba1_forward(tp, torch.from_numpy(x), N, RANK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mamba1_init_matches_jax_deterministic_leaves():
    want = jax_mamba.init_mamba1(jax.random.PRNGKey(0), D_MODEL, D_INNER, N, RANK, WIDTH,
                                 jnp.float32)
    got = pt_mamba.init_mamba1(torch.Generator().manual_seed(0), D_MODEL, D_INNER, N, RANK,
                               WIDTH, torch.float32)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and str(got[k].dtype)[6:] == want[k].dtype.name
    for k in ("dt_bias", "D"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # A_log = log(1..n): torch's f32 log is correctly rounded; XLA's CPU log
    # of 7 sits one ulp away
    want_a = np.log(np.arange(1, N + 1, dtype=np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got["A_log"].numpy(), np.broadcast_to(want_a, (D_INNER, N)))
    np.testing.assert_array_max_ulp(got["A_log"].numpy(), np.asarray(want["A_log"]), maxulp=1)


def test_mamba1_decode_steps_match_jax():
    """Five decode steps from a zero cache: outputs and both caches."""
    jp, tp = _block_params(seed=4)
    xs = np.random.default_rng(5).standard_normal((5, 2, 1, D_MODEL)).astype(np.float32)
    jc = jax_mamba.init_mamba1_cache(2, D_INNER, N, WIDTH, jnp.float32)
    tc = pt_mamba.init_mamba1_cache(2, D_INNER, N, WIDTH, torch.float32)
    for x in xs:
        want, jc = jax_mamba.mamba1_decode(jp, jnp.asarray(x), jc, N, RANK)
        got, tc = pt_mamba.mamba1_decode(tp, torch.from_numpy(x), tc, N, RANK)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=1e-5)


def test_causal_conv_with_cache_matches_jax():
    g = np.random.default_rng(6)
    x = g.standard_normal((2, 5, 8)).astype(np.float32)
    w = g.standard_normal((WIDTH, 8)).astype(np.float32)
    cache = g.standard_normal((2, WIDTH - 1, 8)).astype(np.float32)
    for c in (None, cache):
        want, want_c = jax_mamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                              None if c is None else jnp.asarray(c))
        got, got_c = pt_mamba._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                           None if c is None else torch.from_numpy(c))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_scan_op_rejects_other_devices():
    a = {k: torch.from_numpy(v).to("meta") for k, v in _inputs(1, 4, 8, 4).items()}
    with pytest.raises(ValueError):
        selective_scan_op(*[a[k] for k in ("dt", "Bm", "Cm", "x", "A_log", "D")])
