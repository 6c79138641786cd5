"""The port's Mamba2 block (zamba2) against the JAX package's, on the CPU.

The JAX block runs its recurrence in jnp (``chunked_selective_scan``, an
associative scan within chunks of 16); the port's runs the chunked matrix
("SSD") form in chunks of 64 (``repro_torch.models.mamba.ssd_scan``). On the
same converted params (state 64, as zamba2-7b's; A_log and dt_bias drawn so
that heads decay at different rates) and inputs, in f32:

* ``mamba2_forward`` within 1e-5 of max |y| of the JAX block's, at lengths
  that span several of the port's chunks and end inside one;
* ``mamba2_decode`` within 1e-5 of max |y| at every step, its ssm and conv
  caches within 1e-5 of the JAX package's;
* teacher-forced decode within 1e-5 of max |y| of the port's own forward;
* ``ssd_scan`` within 1e-5 of max |y| of a plain loop over time steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import mamba as jax_mamba  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.models import mamba as pt_mamba  # noqa: E402

D, DI, N, W = 64, 256, 64, 4  # d_model, d_inner (4 heads of 64), zamba2's state, conv width


def _params(seed=0):
    p = dict(jax_mamba.init_mamba2(jax.random.PRNGKey(seed), D, DI, N, W, jnp.float32))
    g = np.random.default_rng(seed)
    p["A_log"] = jnp.asarray(g.normal(size=p["A_log"].shape).astype(np.float32))
    p["dt_bias"] = jnp.asarray(g.normal(size=p["dt_bias"].shape).astype(np.float32))
    p["D"] = jnp.asarray(g.normal(size=p["D"].shape).astype(np.float32))
    return p, from_numpy(p, device="cpu")


def _x(b, s, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)


@pytest.mark.parametrize("s", [64, 200, 320])
def test_mamba2_forward_matches_jax(s):
    pj, pt = _params()
    x = _x(2, s)
    want = np.asarray(jax_mamba.mamba2_forward(pj, jnp.asarray(x), N))
    got = pt_mamba.mamba2_forward(pt, torch.from_numpy(x), N).numpy()
    assert got.shape == want.shape == (2, s, D)
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())


def test_mamba2_decode_matches_jax_and_own_forward():
    pj, pt = _params(seed=3)
    b, steps = 2, 24
    x = _x(b, steps, seed=4)
    cj = jax_mamba.init_mamba2_cache(b, DI, N, W, jnp.float32)
    ct = pt_mamba.init_mamba2_cache(b, DI, N, W, torch.float32)
    assert {k: tuple(v.shape) for k, v in ct.items()} == {k: v.shape for k, v in cj.items()}
    full = pt_mamba.mamba2_forward(pt, torch.from_numpy(x), N)
    scale = float(full.abs().max())
    for t in range(steps):
        yj, cj = jax_mamba.mamba2_decode(pj, jnp.asarray(x[:, t:t + 1]), cj, N)
        yt, ct = pt_mamba.mamba2_decode(pt, torch.from_numpy(x[:, t:t + 1]), ct, N)
        assert float(np.abs(yt.numpy() - np.asarray(yj)).max()) <= 1e-5 * scale, t
        assert float((yt[:, 0] - full[:, t]).abs().max()) <= 1e-5 * scale, t
    for k in ("conv", "ssm"):
        want = np.asarray(cj[k])
        assert float(np.abs(ct[k].numpy() - want).max()) <= 1e-5 * max(float(np.abs(want).max()),
                                                                        1.0), k


def test_ssd_scan_matches_a_loop_over_time_steps():
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t, stepped one
    token at a time, against the chunked form over 3 chunks and a ragged
    end (s = 150 at chunk 64)."""
    g = torch.Generator().manual_seed(5)
    b, s, H, P = 2, 150, 3, 8
    xh = torch.randn((b, s, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, s, H), generator=g))
    A = -torch.rand((H,), generator=g) * 2
    Bm, Cm = torch.randn((b, s, N), generator=g), torch.randn((b, s, N), generator=g)
    got = pt_mamba.ssd_scan(xh, dt, A, Bm, Cm)
    h = torch.zeros((b, H, P, N))
    want = []
    for t in range(s):
        h = torch.exp(dt[:, t] * A)[..., None, None] * h \
            + (dt[:, t, :, None] * xh[:, t])[..., None] * Bm[:, t, None, None, :]
        want.append(h @ Cm[:, t, None, :, None])
    want = torch.stack(want, dim=1)[..., 0]
    assert got.shape == want.shape == (b, s, H, P)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
