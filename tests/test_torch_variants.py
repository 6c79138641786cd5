"""The kernel variants of ``python -m repro_torch.kernels.variants`` and the
data built for the codec kernels' tie rules, checked on the CPU.

Each variant edits a shipped CUDA source by text, so each edit must match
exactly once there (else the variant would not be what its name says). The
quantizer's tie data must be what the planted reciprocal fault fails on:
exact .5 ties under the true divide that the plain version and the JAX
package's numpy encoder compute.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compress import make_codec as jax_make_codec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.codec import ref  # noqa: E402
from repro_torch.kernels.variants import KERNELS, VARIANTS, half_ties, variant_text  # noqa: E402


@pytest.mark.parametrize("variant", VARIANTS, ids=[v.name for v in VARIANTS])
def test_variant_edits_match_once_in_the_shipped_source(variant):
    assert variant.source in KERNELS
    shipped = (_build.CSRC / variant.source).read_text()
    assert variant.edits and not variant.text
    for old, _ in variant.edits:
        assert shipped.count(old) == 1, old
    edited = variant_text(variant)
    assert edited != shipped
    for _, new in variant.edits:
        assert new in edited


def test_every_codec_source_has_a_planted_fault():
    faults = {v.source for v in VARIANTS if v.name.startswith("fault:")}
    assert {"topk_pack.cu", "quant_pack.cu", "flash_attention.cu",
            "selective_scan_bwd.cu"} <= faults


@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("chunk", (64, 1024, 4096))
def test_half_ties_break_a_reciprocal_quantizer(bits, chunk):
    x = half_ties(3, 4, chunk, bits, seed=chunk)
    assert x.shape == (3, 4 * chunk) and x.dtype == np.float32
    qmax = float(2 ** (bits - 1) - 1)
    codes, scales = ref.quantize_rows(torch.from_numpy(x), bits, chunk)
    host = jax_make_codec(f"int{bits}", chunk=chunk)._encode_leaf(x[0])
    np.testing.assert_array_equal(codes[0].numpy().reshape(-1), host["codes"].reshape(-1))
    np.testing.assert_array_equal(scales[0].numpy(), host["scales"])
    # each chunk's absmax is its first element, the rest sit on .5 ties
    blocks = torch.from_numpy(x).reshape(-1, chunk)
    s = scales.reshape(-1, 1)
    np.testing.assert_array_equal(s[:, 0].numpy(), blocks[:, 0].numpy() / np.float32(qmax))
    q = blocks[:, 1:] / s
    assert float((q - torch.floor(q) == 0.5).float().mean()) > 0.8
    # the planted fault's arithmetic: a multiply by the f32 reciprocal
    recip = torch.clamp(torch.round(blocks * (1.0 / s)), -qmax, qmax).to(torch.int8)
    plain = ref.quantize_ref(blocks, qmax)[0]
    assert float((recip != plain).float().mean()) > 0.04
