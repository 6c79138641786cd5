"""The port's FedAvg mix (plain version, on the CPU) against the Pallas
``gossip_mix`` in interpret mode.

The sum order differs (the port sums the n rows in order, one rounding per
product and per sum; the Pallas kernel is an einsum), so the results agree
within rtol 1e-6 of max|x|. The port's kernel has a leading batch (node)
axis; each batch row is held to the Pallas call on that row alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mixing.gossip_mix import gossip_mix  # noqa: E402
from repro_torch.kernels.mixing.ops import fedavg_mean, gossip_mix_op  # noqa: E402
from repro_torch.kernels.mixing.ref import gossip_mix_ref  # noqa: E402


def _weights(n, uniform, rng):
    if uniform:
        return np.full(n, 1.0 / n, dtype=np.float32)
    w = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    return (w / w.sum()).astype(np.float32)


@pytest.mark.parametrize("n", (1, 2, 5, 10))
@pytest.mark.parametrize("p", (7, 1000, 4099, 20_000))
@pytest.mark.parametrize("uniform", (True, False))
def test_mix_matches_pallas(n, p, uniform):
    rng = np.random.default_rng(n * 7 + p)
    buf = rng.normal(size=(3, n, p)).astype(np.float32) * 5
    w = _weights(n, uniform, rng)
    out = gossip_mix_op(torch.from_numpy(buf), torch.from_numpy(w)).numpy()
    assert out.shape == (3, p) and out.dtype == np.float32
    for b in range(3):
        want = np.asarray(gossip_mix(jnp.asarray(buf[b]), jnp.asarray(w), interpret=True))
        assert np.abs(out[b] - want).max() <= 1e-6 * np.abs(buf[b]).max()


def test_fedavg_mean_matches_jnp_mean():
    rng = np.random.default_rng(0)
    buf = rng.normal(size=(4, 10, 3001)).astype(np.float32)
    out = fedavg_mean(torch.from_numpy(buf)).numpy()
    want = np.asarray(jnp.mean(jnp.asarray(buf), axis=1))
    assert np.abs(out - want).max() <= 1e-6 * np.abs(buf).max()


def test_mix_bf16_accumulates_in_f32():
    rng = np.random.default_rng(1)
    buf = torch.from_numpy(rng.normal(size=(2, 6, 513)).astype(np.float32)).to(torch.bfloat16)
    w = torch.full((6,), 1 / 6)
    out = gossip_mix_op(buf, w)
    assert out.dtype == torch.bfloat16
    want = np.asarray(gossip_mix(jnp.asarray(buf[0].float().numpy()).astype(jnp.bfloat16),
                                 jnp.asarray(w.numpy()), interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(out[0].float().numpy(), want, rtol=2 ** -7, atol=1e-6)


def test_ref_is_the_ordered_sum():
    """The plain version's arithmetic, which the kernel repeats bit for bit."""
    rng = np.random.default_rng(2)
    buf = rng.normal(size=(2, 4, 9)).astype(np.float32)
    w = rng.uniform(size=4).astype(np.float32)
    acc = np.zeros((2, 9), np.float32)
    for i in range(4):
        acc = acc + w[i] * buf[:, i]
    np.testing.assert_array_equal(
        gossip_mix_ref(torch.from_numpy(buf), torch.from_numpy(w)).numpy(), acc)
