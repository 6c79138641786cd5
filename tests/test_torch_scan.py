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
* The backward: ``selective_scan_bwd_ref`` (the explicit adjoint) against
  ``jax.grad`` of the jnp oracle for every input, with a zero (None) and a
  non-zero gradient of the last state, within 1e-5 of each gradient's max
  |g| (the same f32 terms summed in another order). The kernel's
  decomposition (``selective_scan_bwd_blocked``: the forward's chunk
  states, reverse chunks, the segments' reversed pair scan, dB and dC
  summed a block of channels at a time) against the ref at ragged lengths
  and channel counts, within 1e-5. The Mamba1 block through the
  ``SelectiveScan`` Function against ``jax.grad`` of
  ``repro.models.mamba.mamba1_forward`` in f32, within 1e-4 of each leaf's
  max |g| (the block's projections and conv sum in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.scan.mamba_scan import mamba_selective_scan  # noqa: E402
from repro.kernels.scan.ref import selective_scan_ref as jax_scan_ref  # noqa: E402
from repro.models import mamba as jax_mamba  # noqa: E402
from repro_torch.kernels.scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.scan.ops import SelectiveScan, selective_scan_op  # noqa: E402
from repro_torch.kernels.scan.ref import (  # noqa: E402
    selective_scan_blocked,
    selective_scan_bwd_blocked,
    selective_scan_bwd_ref,
    selective_scan_ref,
)
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


# -- the backward ----------------------------------------------------------------------

NAMES = ("dt", "Bm", "Cm", "x", "A_log", "D")


def _jax_grads(a, dy, dh):
    """jax.grad of sum(y dy) + sum(h_last dh) through the jnp oracle."""
    def loss(*args):
        y, h = jax_scan_ref(*args)
        return jnp.sum(y * dy) + (0.0 if dh is None else jnp.sum(h * dh))
    return jax.grad(loss, argnums=tuple(range(6)))(*[jnp.asarray(a[k]) for k in NAMES])


def _assert_grads_close(got, want, rel, what=""):
    for name, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= rel * max(scale, 1e-30), f"{what} d{name}: {err} > {rel} x {scale}"


@pytest.mark.parametrize("with_dh", [False, True], ids=["dh_zero", "dh_nonzero"])
@pytest.mark.parametrize("b,s,di,n", [(2, 37, 16, 4), (1, 70, 24, 16), (3, 9, 8, 1),
                                      (1, 130, 12, 32)])
def test_bwd_ref_matches_jax_grad_of_the_oracle(b, s, di, n, with_dh):
    a = _inputs(b, s, di, n, seed=s + n)
    g = np.random.default_rng(7)
    dy = g.standard_normal((b, s, di)).astype(np.float32)
    dh = g.standard_normal((b, di, n)).astype(np.float32) if with_dh else None
    want = _jax_grads(a, dy, dh)
    t = [torch.from_numpy(a[k]) for k in NAMES]
    got = selective_scan_bwd_ref(*t, torch.from_numpy(dy),
                                 None if dh is None else torch.from_numpy(dh))
    # the ref returns (ddt, dB, dC, dx, dA_log, dD): the inputs' order
    _assert_grads_close([x.numpy() for x in got], want, 1e-5)
    if not with_dh:  # None and an explicit zero gradient agree
        zero = selective_scan_bwd_ref(*t, torch.from_numpy(dy), torch.zeros((b, di, n)))
        for x, z in zip(got, zero):
            assert torch.equal(x, z)


@pytest.mark.parametrize("b,s,di,n,items,segments,block", [
    (2, 96, 64, 8, 5, 4, 16),  # 20-step chunks, the last ragged; 4 blocks of channels
    (1, 75, 70, 16, 16, 4, 64),  # the kernels' geometry: two chunks, ragged; 70 = 64 + 6
    (2, 300, 8, 4, 16, 4, 64),  # five chunks, one ragged block
    (1, 1, 8, 32, 16, 4, 4),
    (3, 64, 24, 1, 3, 3, 8),
    # the backward's 16-warp variant (kernels/variants.py): 8 segments of 8 steps
    (1, 200, 64, 16, 8, 8, 64),  # four chunks, the last ragged
    (2, 65, 70, 1, 8, 8, 64),  # one step past a chunk; 70 = 64 + 6 channels; one state
    (1, 130, 70, 17, 8, 8, 64),  # an odd state count (a padding state in the kernel)
    (1, 63, 68, 32, 8, 8, 64),  # one step short of a chunk; n = 32, two passes of 16
])
def test_blocked_bwd_decomposition_matches_ref(b, s, di, n, items, segments, block):
    a = _inputs(b, s, di, n, seed=s + di)
    g = np.random.default_rng(8)
    t = [torch.from_numpy(a[k]) for k in NAMES]
    dy = torch.from_numpy(g.standard_normal((b, s, di)).astype(np.float32))
    dh = torch.from_numpy(g.standard_normal((b, di, n)).astype(np.float32))
    y, h, h_chunks = selective_scan_blocked(*t, items=items, segments=segments,
                                            return_chunk_states=True)
    # the chunk states are the states entering each chunk of the step-by-step scan
    chunk = items * segments
    assert h_chunks.shape == (b, -(-s // chunk), di, n)
    for k in range(h_chunks.shape[1]):
        if k == 0:
            assert float(h_chunks[:, 0].abs().max()) == 0.0
            continue
        _, want_h = selective_scan_ref(*[x[:, :k * chunk] if x.dim() == 3 else x for x in t])
        np.testing.assert_allclose(h_chunks[:, k].numpy(), want_h.numpy(), atol=1e-5)
    for dhl in (None, dh):
        got = selective_scan_bwd_blocked(*t, h_chunks, dy, dhl, items=items, segments=segments,
                                         block_channels=block)
        want = selective_scan_bwd_ref(*t, dy, dhl)
        _assert_grads_close([x.numpy() for x in got], [x.numpy() for x in want], 1e-5,
                            "dh" if dhl is not None else "")


def _mamba_init_inputs(b, s, di, n, seed=0):
    """Mamba's initialization: dt log-uniform in [1e-3, 1e-1] and A = -(1 ..
    n), so a state decays over hundreds of steps and the carries between
    segments and chunks weigh (with dt softplus(N(0, 1)) a state falls below
    f32 rounding within ~40 steps, and a wrong carry hides)."""
    a = _inputs(b, s, di, n, seed)
    g = np.random.default_rng(seed + 1)
    a["dt"] = np.exp(g.uniform(np.log(1e-3), np.log(1e-1), (b, s, di))).astype(np.float32)
    a["A_log"] = np.log(np.broadcast_to(np.arange(1, n + 1, dtype=np.float32), (di, n))).copy()
    return a


@pytest.mark.parametrize("items,segments", [(16, 4), (8, 8)], ids=["16x4", "8x8"])
@pytest.mark.parametrize("b,s,di,n", [(1, 200, 70, 16), (2, 130, 64, 17), (1, 65, 68, 32)])
def test_blocked_bwd_decomposition_at_mamba_init(b, s, di, n, items, segments):
    """The backward's decomposition (the kernel's 4 segments of 16 steps and
    its 16-warp variant's 8 of 8, 64 channels a block) from the forward's
    chunk states, against the ref within 1e-5, where long-lived states make
    every carry count."""
    a = _mamba_init_inputs(b, s, di, n, seed=s)
    g = np.random.default_rng(9)
    t = [torch.from_numpy(a[k]) for k in NAMES]
    dy = torch.from_numpy(g.standard_normal((b, s, di)).astype(np.float32))
    dh = torch.from_numpy(g.standard_normal((b, di, n)).astype(np.float32))
    _, _, h_chunks = selective_scan_blocked(*t, return_chunk_states=True)
    for dhl in (None, dh):
        got = selective_scan_bwd_blocked(*t, h_chunks, dy, dhl, items=items, segments=segments)
        want = selective_scan_bwd_ref(*t, dy, dhl)
        _assert_grads_close([x.numpy() for x in got], [x.numpy() for x in want], 1e-5,
                            "dh" if dhl is not None else "")


def _count_scan_calls(monkeypatch):
    """Counts of SelectiveScan's forwards and of the plain backward calls."""
    calls = {"forward": 0, "backward": 0}
    apply, bwd = SelectiveScan.apply, scan_ops.selective_scan_bwd_ref

    def counted_apply(*args):
        calls["forward"] += 1
        return apply(*args)

    def counted_bwd(*args):
        calls["backward"] += 1
        return bwd(*args)

    monkeypatch.setattr(SelectiveScan, "apply", counted_apply)
    monkeypatch.setattr(scan_ops, "selective_scan_bwd_ref", counted_bwd)
    return calls


@pytest.mark.parametrize("s", [7, 48, 70])
def test_mamba1_block_grads_match_jax_through_selective_scan(s, monkeypatch):
    jp, tp = _block_params(seed=9)
    g = np.random.default_rng(10)
    x = g.standard_normal((2, s, D_MODEL)).astype(np.float32)
    w = g.standard_normal((2, s, D_MODEL)).astype(np.float32)
    names = sorted(jp)

    def jloss(p, xx):
        return jnp.sum(jax_mamba.mamba1_forward(p, xx, N, RANK, chunk=16) * w)

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    calls = _count_scan_calls(monkeypatch)
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = pt_mamba.mamba1_forward(tp, xt, N, RANK)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), [tp[k] for k in names] + [xt])
    assert calls == {"forward": 1, "backward": 1}
    for name, got, want in zip(names + ["x"], grads, [want_p[k] for k in names] + [want_x]):
        want = np.asarray(want, np.float64)
        err, scale = float(np.abs(got.double().numpy() - want).max()), float(np.abs(want).max())
        assert err <= 1e-4 * scale, f"d{name}: {err} > 1e-4 x {scale}"


def test_selective_scan_function_takes_either_output_alone():
    """A loss of h_last alone (dy None) or of y alone (dh_last None) gives
    the ref's gradients with the other output's gradient zero."""
    a = _inputs(2, 20, 8, 4, seed=11)
    t = [torch.from_numpy(a[k]).requires_grad_() for k in NAMES]
    g = np.random.default_rng(12)
    dy = torch.from_numpy(g.standard_normal((2, 20, 8)).astype(np.float32))
    dh = torch.from_numpy(g.standard_normal((2, 8, 4)).astype(np.float32))
    for use_y, use_h in ((True, False), (False, True)):
        y, h = selective_scan_op(*t)
        loss = (y * dy).sum() if use_y else (h * dh).sum()
        got = torch.autograd.grad(loss, t)
        want = selective_scan_bwd_ref(*[x.detach() for x in t],
                                      dy if use_y else torch.zeros_like(dy),
                                      dh if use_h else None)
        _assert_grads_close([x.numpy() for x in got], [x.numpy() for x in want], 1e-6)
