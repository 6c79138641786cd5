"""The Hopper kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips (decided inside
the ``cuda`` fixture, never at import). On the card:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Codes, scales, values, indices and the mix are bit-identical to the plain
versions; the gossip round on the card equals the round on the CPU up to
the mix's f32 rounding (the same arithmetic in the same order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compress import make_codec  # noqa: E402
from repro_torch.dfl.collectives import GossipPlan, gossip_exchange  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.codec import ref  # noqa: E402
from repro_torch.kernels.codec.ops import (  # noqa: E402
    dequantize_op,
    quantize_op,
    topk_select_op,
)
from repro_torch.kernels.mixing.ops import gossip_mix_op  # noqa: E402
from repro_torch.kernels.mixing.ref import gossip_mix_ref  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _x(rows, size, seed=0, ties=False):
    g = np.random.default_rng(seed)
    x = g.normal(size=(rows, size)).astype(np.float32) * 3
    if ties:
        x = (np.round(x * 4) / 4).astype(np.float32)
        x[:, : size // 3] = 0
    return torch.from_numpy(x)


@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("size", (1, 1000, 1027, 4096, 70_001, 5_300_000))
@pytest.mark.parametrize("ties", (False, True))
def test_quantize_kernel_matches_plain(cuda, bits, size, ties):
    x = _x(3, size, ties=ties)
    reset_launches()
    codes, scales = quantize_op(x.to(cuda), bits=bits)
    assert LAUNCHES["quantize"] == 1
    want_c, want_s = ref.quantize_rows(x, bits, 1024)
    assert torch.equal(codes.cpu(), want_c) and torch.equal(scales.cpu(), want_s)
    # the plain version gives the same wire on the card as on the CPU
    card_c, card_s = ref.quantize_rows(x.to(cuda), bits, 1024)
    assert torch.equal(card_c.cpu(), want_c) and torch.equal(card_s.cpu(), want_s)
    out = dequantize_op(codes, scales, size=size, bits=bits)
    assert LAUNCHES["dequantize"] == 1
    assert torch.equal(out.cpu(), ref.dequantize_rows(want_c, want_s, size, bits, 1024))


def test_quantize_kernel_handles_unaligned_rows(cuda):
    x = _x(1, 4097)[:, 1:].contiguous().to(cuda)  # size 4096 at an offset
    base = torch.empty(4097, device=cuda)
    view = base[1:].view(1, 4096)
    view.copy_(x)
    codes, scales = quantize_op(view, bits=8)
    want_c, want_s = ref.quantize_rows(x.cpu(), 8, 1024)
    assert torch.equal(codes.cpu(), want_c) and torch.equal(scales.cpu(), want_s)


@pytest.mark.parametrize("block", (32, 96, 256, 1024))
@pytest.mark.parametrize("k", (1, 13, 32))
@pytest.mark.parametrize("ties", (False, True))
def test_topk_kernel_matches_plain(cuda, block, k, ties):
    x = _x(2, 5 * block + 7, seed=block + k, ties=ties)
    reset_launches()
    vals, idx = topk_select_op(x.to(cuda), k=k, block=block)
    assert LAUNCHES["topk_select"] == 1
    want_v, want_i = ref.topk_select_rows(x, k, block)
    assert torch.equal(vals.cpu(), want_v) and torch.equal(idx.cpu(), want_i)


def test_topk_kernel_rejects_bad_blocks(cuda):
    x = torch.zeros(1, 100, device=cuda)
    for block, k in ((48, 4), (2048, 4), (256, 0), (32, 33)):
        with pytest.raises(ValueError):
            topk_select_op(x, k=k, block=block)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("p", (1, 4099, 100_000))
def test_mix_kernel_matches_plain(cuda, dtype, p):
    buf = _x(3 * 7, p, seed=p).reshape(3, 7, p).to(dtype)
    w = torch.from_numpy(np.random.default_rng(p).uniform(size=7).astype(np.float32))
    reset_launches()
    out = gossip_mix_op(buf.to(cuda), w.to(cuda))
    assert LAUNCHES["gossip_mix"] == 1
    assert torch.equal(out.cpu(), gossip_mix_ref(buf, w))


@pytest.mark.parametrize("mode,codec", [
    ("dissemination", None), ("dissemination", "int8"), ("dissemination", "topk"),
    ("segmented", "int4"), ("tree_allreduce", "int8"), ("tree_allreduce", None),
    ("mixing", None), ("flooding", "int8"), ("allreduce_ref", None)])
def test_gossip_round_on_card_matches_cpu(cuda, mode, codec):
    plan = GossipPlan.build(4)
    params = {"w": _x(4, 3050, seed=9).reshape(4, 50, 61), "b": _x(4, 1027, seed=3)}
    c = make_codec(codec) if codec else None
    on_card = gossip_exchange(mode, plan, {k: v.to(cuda) for k, v in params.items()}, codec=c)
    on_cpu = gossip_exchange(mode, plan, params, codec=c)
    for k in params:
        # the mix, quantizer and top-k are bit-identical to the plain
        # versions; torch's own reductions (allreduce_ref) may sum in
        # another order on the card
        tol = 1e-6 * float(params[k].abs().max())
        assert float((on_card[k].cpu() - on_cpu[k]).abs().max()) <= tol


def test_runner_proxy_on_card_matches_cpu(cuda):
    from repro_torch.scenario import run_scenario

    for name in ("quantized_table3", "mesh_smoke", "topk_sweep"):
        a = run_scenario(name, device="cuda", proxy_elems=4)
        b = run_scenario(name, device="cpu", proxy_elems=4)
        for ra, rb in zip(a.rounds, b.rounds):
            assert (ra.n_slots, ra.transmissions, ra.bytes_on_wire_mb, ra.numerics_ok) == \
                (rb.n_slots, rb.transmissions, rb.bytes_on_wire_mb, rb.numerics_ok)
            assert ra.device_ms is not None and ra.device_ms > 0
