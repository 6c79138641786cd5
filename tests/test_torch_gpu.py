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
from repro_torch.kernels.codec.group import group_layout  # noqa: E402
from repro_torch.kernels.codec.ops import (  # noqa: E402
    dequantize_group_op,
    dequantize_op,
    quantize_op,
    topk_select_op,
)
from repro_torch.kernels.mixing.ops import gossip_mix_op  # noqa: E402
from repro_torch.kernels.mixing.ref import gossip_mix_ref  # noqa: E402
from repro_torch.kernels.variants import half_ties  # noqa: E402

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


def _card_group(cuda, rows, sizes, bits, chunk=1024, offset=0, seed=0):
    """A group's arenas on the card, each leaf quantized on its own into
    them; ``offset`` bytes shift the codes arena off 16-byte alignment."""
    layout = group_layout(rows, tuple(sizes), bits, chunk)
    codes, scales = layout.arenas(cuda)
    if offset:
        base = torch.empty(codes.numel() + offset, dtype=codes.dtype, device=cuda)
        codes = base[offset:].view(codes.shape)
    for l, size in enumerate(sizes):
        x = _x(rows, size, seed=seed + l) * (l + 1)
        quantize_op(x.to(cuda), bits=bits, chunk=chunk,
                    out=(layout.codes(codes, l), layout.scales(scales, l)))
    return layout, codes, scales


def _group_matches_plain(layout, codes, scales, launches=1):
    reset_launches()
    got = dequantize_group_op(codes, scales, layout)
    assert LAUNCHES["dequantize"] == launches
    want = ref.dequantize_group(codes.cpu(), scales.cpu(), layout)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("rows", (1, 2, 3))
def test_dequantize_group_kernel_matches_plain(cuda, bits, rows):
    """One launch for ragged, tiny, empty and misaligned leaves (sizes not a
    multiple of 4 misalign every later row of the leaf), bit for bit."""
    sizes = (0, 3, 384, 1000, 0, 1027, 1536, 5000, 4097, 1)
    _group_matches_plain(*_card_group(cuda, rows, sizes, bits))


@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("chunk", (4, 64, 1020, 4096, 8192))
@pytest.mark.parametrize("offset", (0, 4))
def test_dequantize_group_kernel_every_chunk_size(cuda, bits, chunk, offset):
    """Code widths that are whole 16-byte pieces (in registers, or tiles of
    a long chunk) and that are not (4 codes a load), and a codes arena off
    16 bytes."""
    sizes = (3 * chunk + 3, chunk, 5, 2 * chunk)
    _group_matches_plain(*_card_group(cuda, 3, sizes, bits, chunk=chunk, offset=offset))


def test_dequantize_group_kernel_past_65535_chunks(cuda):
    """A group of 65,630 chunks: the grid strides, nothing is cut at 2^16."""
    layout, codes, scales = _card_group(cuda, 2, (33_600_000, 1027), 8)
    assert layout.total_chunks > 65_535
    _group_matches_plain(layout, codes, scales)


# a lone leaf of at least 16,384 chunks takes the CTA-a-chunk kernel
CTA_CASES = [(1, 64, 16_384 * 64 + 5), (3, 1024, 5_462 * 1024 - 1), (2, 2048, 8_192 * 2048 + 3)]


@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("rows,chunk,size", CTA_CASES)
def test_dequantize_lone_large_leaf_matches_plain(cuda, bits, rows, chunk, size):
    """The CTA kernel, bit for bit, in one launch: ragged rows, sizes that
    misalign later rows, chunks a CTA decodes in one and two passes."""
    layout, codes, scales = _card_group(cuda, rows, (size,), bits, chunk=chunk)
    assert layout.total_chunks >= 16_384
    _group_matches_plain(layout, codes, scales)


def test_dequantize_group_launches_once_a_group(cuda):
    """The quantizer's round trip of a group: one quantize a non-empty leaf,
    one dequantize for all; each leaf as it is alone."""
    codec = make_codec("int8")
    ts = [_x(3, s, seed=s).to(cuda) for s in (1027, 0, 384, 5000)]
    ts[2] = ts[2].bfloat16()
    reset_launches()
    got = codec.roundtrip_group(ts)
    assert LAUNCHES["dequantize"] == 1 and LAUNCHES["quantize"] == 3
    for g, t in zip(got, ts):
        want = codec.roundtrip(t)
        assert g.dtype == t.dtype and torch.equal(g, want)
    reset_launches()
    plan = GossipPlan.build(4)
    params = {"w": _x(4, 3050, seed=9).reshape(4, 50, 61).to(cuda), "b": _x(4, 1027).to(cuda)}
    grouped = gossip_exchange("dissemination", plan, params, codec=codec)
    assert LAUNCHES["dequantize"] == len(plan.diss_steps)
    for k, v in params.items():
        alone = gossip_exchange("dissemination", plan, {k: v}, codec=codec)[k]
        assert torch.equal(grouped[k], alone)


def test_dequantize_group_rejects_bad_inputs(cuda):
    layout, codes, scales = _card_group(cuda, 1, (1027, 5), 8)
    with pytest.raises(ValueError):
        dequantize_group_op(codes[:-1], scales, layout)
    with pytest.raises(ValueError):
        dequantize_group_op(codes.view(torch.uint8), scales, layout)
    big = group_layout(1, (1,) * 1025, 8, 1024)
    c, s = big.arenas(cuda)
    with pytest.raises(ValueError, match="at most 1024"):
        dequantize_group_op(c, s, big)


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


def _offset_rows(x, cuda, offset):
    """``x`` copied to the card as a contiguous (rows, size) view starting
    ``offset`` floats into a larger buffer (offset 1: not 16-byte aligned)."""
    base = torch.zeros(x.numel() + offset, device=cuda)
    view = base[offset:].view(x.shape)
    view.copy_(x.to(cuda))
    return view


@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("chunk", (4, 64, 1020, 1024, 4096, 8192))
@pytest.mark.parametrize("offset", (0, 1))
def test_quantize_kernel_every_chunk_size(cuda, bits, chunk, offset):
    """Chunks that fit a lane's registers (up to 1024) and chunks the warp
    loops over, on aligned and unaligned rows, sizes not a multiple of 4."""
    x = _x(3, 3 * chunk + 3, seed=chunk + bits)
    view = _offset_rows(x, cuda, offset)
    assert (view.data_ptr() % 16 == 0) == (offset == 0)
    codes, scales = quantize_op(view, bits=bits, chunk=chunk)
    want_c, want_s = ref.quantize_rows(x, bits, chunk)
    assert torch.equal(codes.cpu(), want_c) and torch.equal(scales.cpu(), want_s)
    x4 = _x(2, 4 * chunk, seed=chunk)  # size % 4 == 0: float4 loads where aligned
    codes, scales = quantize_op(_offset_rows(x4, cuda, offset), bits=bits, chunk=chunk)
    want_c, want_s = ref.quantize_rows(x4, bits, chunk)
    assert torch.equal(codes.cpu(), want_c) and torch.equal(scales.cpu(), want_s)
    out = dequantize_op(codes, scales, size=4 * chunk, bits=bits, chunk=chunk)
    assert torch.equal(out.cpu(), ref.dequantize_rows(want_c, want_s, 4 * chunk, bits, chunk))


@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("chunk", (1024, 4096))
def test_quantize_kernel_rounds_exact_half_ties_to_even(cuda, bits, chunk):
    """x / scale on exact .5 ties: only a true divide and round half to even
    give the plain version's codes (a reciprocal multiply fails here)."""
    x = torch.from_numpy(half_ties(4, 16, chunk, bits, seed=chunk))
    codes, scales = quantize_op(x.to(cuda), bits=bits, chunk=chunk)
    want_c, want_s = ref.quantize_rows(x, bits, chunk)
    assert torch.equal(codes.cpu(), want_c) and torch.equal(scales.cpu(), want_s)


def _topk_matches_plain(x, cuda, k, block):
    vals, idx = topk_select_op(x.to(cuda), k=k, block=block)
    want_v, want_i = ref.topk_select_rows(x, k, block)
    assert torch.equal(idx.cpu(), want_i) and torch.equal(vals.cpu(), want_v)
    # signs, and -0.0 against +0.0, survive the pack
    assert torch.equal(torch.signbit(vals.cpu()), torch.signbit(want_v))


@pytest.mark.parametrize("block", (32, 96, 256, 512, 1024))
@pytest.mark.parametrize("k", (1, 13, "block"))
@pytest.mark.parametrize("ties", (False, True))
def test_topk_kernel_every_block_and_k(cuda, block, k, ties):
    k = block if k == "block" else k
    _topk_matches_plain(_x(3, 4 * block + 5, seed=block + k, ties=ties), cuda, k, block)


@pytest.mark.parametrize("where", ("lane", "across lanes", "both", "contiguous"))
@pytest.mark.parametrize("k", (1, 13, 40))
def test_topk_kernel_ties_at_the_kth_place(cuda, where, k):
    """Equal magnitudes (some negative) straddle the k-th place: within one
    lane (lane l holds indices j * 32 + l), across lanes (one j, every third
    lane), both, or 8 consecutive indices; the lowest indices among them are
    taken."""
    g = np.random.default_rng(k)
    x = g.uniform(-1, 1, size=(8, 256)).astype(np.float32)
    lane = [j * 32 + 5 for j in range(8)]
    across = [3 * 32 + l for l in range(0, 32, 3)]
    spots = {"lane": lane, "across lanes": across, "both": lane + across,
             "contiguous": list(range(40, 48))}[where]
    above = k - 1 - len(spots) // 2  # the tie straddles the k-th place
    for r in range(8):
        big = g.permutation([i for i in range(256) if i not in spots])[:max(above, 0)]
        x[r, big] = g.uniform(5, 9, size=len(big))
        x[r, spots] = np.where(g.random(len(spots)) < 0.5, -2.5, 2.5)
    _topk_matches_plain(torch.from_numpy(x), cuda, k, 256)


def test_topk_kernel_zero_blocks_signed_zeros_and_inf(cuda):
    x = np.random.default_rng(0).normal(size=(6, 1000)).astype(np.float32)
    x[0] = 0.0  # all-zero blocks select 0..k-1
    x[1] = -0.0
    x[2, ::2] = -0.0
    x[2, 1::2] = 0.0
    x[3, [3, 70, 300, 301]] = [np.inf, -np.inf, np.inf, -np.inf]  # fewer than k
    x[4, :40] = -np.inf  # more than k in the first block
    x[5, 256:512] = np.inf
    x[5, 600:] = 0.0
    for k in (1, 13, 200):
        _topk_matches_plain(torch.from_numpy(x), cuda, k, 256)


def test_topk_kernel_rows_not_a_multiple_of_the_block(cuda):
    for rows, size in ((3, 3_500_001), (4, 257), (5, 31)):
        _topk_matches_plain(_x(rows, size, seed=size), cuda, 13, 256)


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
    from repro_torch.scenario import DeviceExecutor, run_scenario

    for name in ("quantized_table3", "mesh_smoke", "topk_sweep"):
        runs = []
        for device in ("cuda", "cpu"):
            ex = DeviceExecutor(device=device, proxy_elems=4)
            run_scenario(name, executor=ex)
            runs.append(ex.run)
        a, b = runs
        for ra, rb in zip(a.rounds, b.rounds):
            assert (ra.n_slots, ra.transmissions, ra.bytes_on_wire_mb, ra.numerics_ok) == \
                (rb.n_slots, rb.transmissions, rb.bytes_on_wire_mb, rb.numerics_ok)
            assert ra.device_ms is not None and ra.device_ms > 0


# -- model kernels: flash attention and the Mamba1 selective scan ------------------

from repro_torch.dfl.collectives import tree_map  # noqa: E402
from repro_torch.kernels.attention.ops import flash_attention_op  # noqa: E402
from repro_torch.kernels.attention.ref import (  # noqa: E402
    BF16_UNITS_TOL,
    attention_ref,
    rounding_units,
)
from repro_torch.kernels.scan.mamba_scan import (  # noqa: E402
    mamba_selective_scan,
    selective_scan_bwd,
)
from repro_torch.kernels.scan.ops import selective_scan_op  # noqa: E402
from repro_torch.kernels.scan.ref import (  # noqa: E402
    SCAN_BWD_BF16_TOL,
    SCAN_BWD_TOL,
    selective_scan_blocked,
    selective_scan_bwd_ref,
    selective_scan_ref,
)


def _normal(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape, dtype=np.float32))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,softcap", [
    (2, 256, 4, 4, 64, True, 0, 0.0),
    (1, 200, 6, 2, 64, True, 0, 0.0),  # ragged tiles, GQA
    (1, 77, 3, 1, 32, False, 0, 0.0),
    (2, 384, 5, 5, 32, True, 256, 30.0),
    (1, 320, 4, 2, 128, True, 100, 0.0),
    (1, 300, 8, 4, 256, True, 128, 50.0),  # gemma2's head dim
    (4, 2048, 15, 5, 64, True, 0, 0.0),  # smollm-360m's prefill: GQA 3:1
    (1, 300, 4, 2, 128, True, 0, 0.0),  # three 128-key tiles, s % 128 != 0
    (2, 333, 4, 4, 128, False, 0, 0.0),
    (1, 700, 8, 4, 256, True, 150, 50.0),  # gemma2: window across 64-key tiles, softcap
    (1, 1, 4, 2, 64, True, 0, 0.0),
    (2, 1, 2, 1, 256, False, 0, 30.0),
    (1, 129, 4, 1, 32, True, 64, 0.0),
    (1, 300, 4, 4, 112, True, 0, 0.0),  # zamba2's head dim: slabs padded inside the kernel
    (1, 257, 6, 3, 112, True, 64, 50.0),
    (1, 333, 8, 2, 160, True, 100, 0.0),  # stablelm-12b's head dim: 2.5 slabs
    (2, 200, 4, 1, 160, False, 0, 30.0),
])
def test_flash_kernel_matches_plain(cuda, dtype, atol, b, s, h, kv, hd, causal, window, softcap):
    q = _normal((b, s, h, hd), 1).to(dtype)
    k, v = _normal((b, s, kv, hd), 2).to(dtype), _normal((b, s, kv, hd), 3).to(dtype)
    kw = dict(causal=causal, sliding_window=window, softcap=softcap)
    reset_launches()
    out = flash_attention_op(q.to(cuda), k.to(cuda), v.to(cuda), **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1 and out.dtype == dtype
    want = attention_ref(q.to(cuda), k.to(cuda), v.to(cuda), **kw)
    assert float((out.float() - want.float()).abs().max()) <= atol
    if dtype == torch.bfloat16:  # and each element within its own rounding's reach
        assert rounding_units(out, q.to(cuda), k.to(cuda), v.to(cuda), **kw) <= BF16_UNITS_TOL


@pytest.mark.parametrize("hd", (64, 112, 160))
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_flash_kernel_reads_strided_heads(cuda, dtype, atol, hd):
    """q, k and v as views into one fused (b, s, H + 2 KV, hd) projection (in
    bf16, TMA reads them through their strides: 224 and 320 bytes a head at
    hd 112 and 160)."""
    qkv = _normal((2, 130, 8 + 2 + 2, hd), 4).to(dtype).to(cuda)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out = flash_attention_op(q, k, v, causal=True)
    want = attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert float((out.float() - want.float()).abs().max()) <= atol
    if dtype == torch.bfloat16:
        assert rounding_units(out, q, k, v, causal=True) <= BF16_UNITS_TOL


@pytest.mark.parametrize("b,s,h,kv,hd,window,softcap", [
    (1, 700, 8, 4, 256, 150, 50.0),  # gemma2's local layer
    (1, 1100, 8, 4, 256, 0, 50.0),
    (2, 384, 5, 5, 32, 256, 30.0),
    (1, 300, 6, 2, 64, 0, 30.0),
])
def test_flash_kernel_softcap_with_scores_near_the_cap(cuda, b, s, h, kv, hd, window, softcap):
    """q scaled so the scores' std is half the cap: the softcap's tanh works
    where it bends, and a tanh that errs by 2^-11 of its value moves the
    logits by up to 0.02 (std-1 scores stay near s / c = 0.02, where no
    such error shows)."""
    q = (_normal((b, s, h, hd), 1) * (softcap / 2)).to(torch.bfloat16).to(cuda)
    k = _normal((b, s, kv, hd), 2).to(torch.bfloat16).to(cuda)
    v = _normal((b, s, kv, hd), 3).to(torch.bfloat16).to(cuda)
    kw = dict(causal=True, sliding_window=window, softcap=softcap)
    out = flash_attention_op(q, k, v, **kw)
    assert rounding_units(out, q, k, v, **kw) <= BF16_UNITS_TOL


def test_flash_kernel_rejects_misaligned_bf16_views(cuda):
    base = torch.zeros(1, 8, 4, 64 + 8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        x = base.flatten()[1:1 + 8 * 4 * 64].view(1, 8, 4, 64)  # base 2 bytes off
        flash_attention_op(x, x, x)
    with pytest.raises(ValueError):
        x = base[..., :64].as_strided((1, 8, 4, 64), (8 * 4 * 72, 4 * 72, 68, 1))
        flash_attention_op(x, x, x)  # head stride of 136 bytes


def test_flash_kernel_rejects_bad_inputs(cuda):
    q = torch.zeros(1, 8, 4, 48, device=cuda)
    with pytest.raises(ValueError):
        flash_attention_op(q, q, q)  # head dim 48
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    with pytest.raises(ValueError):
        flash_attention_op(q, q[:, :, :3], q[:, :, :3])  # 3 kv heads for 4
    with pytest.raises(ValueError):
        flash_attention_op(q, q.half(), q.half())


@pytest.mark.parametrize("x_dtype,y_dtype,atol", [
    (torch.float32, torch.float32, 1e-4), (torch.bfloat16, torch.float32, 1e-4),
    (torch.bfloat16, torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("b,s,di,n", [(2, 64, 128, 16), (1, 95, 70, 8), (3, 33, 256, 4),
                                      (1, 40, 48, 12), (2, 17, 64, 32)])
def test_scan_kernel_matches_plain(cuda, x_dtype, y_dtype, atol, b, s, di, n):
    g = np.random.default_rng(s + n)
    dt = torch.from_numpy(np.log1p(np.exp(g.standard_normal((b, s, di)))).astype(np.float32))
    Bm, Cm = _normal((b, s, n), 5), _normal((b, s, n), 6)
    x = _normal((b, s, di), 7).to(x_dtype)
    A_log = torch.from_numpy(np.log(np.abs(g.standard_normal((di, n))) + 0.5).astype(np.float32))
    D = _normal((di,), 8)
    args = [t.to(cuda) for t in (dt, Bm, Cm, x, A_log, D)]
    reset_launches()
    y, h = selective_scan_op(*args, out_dtype=y_dtype)
    torch.cuda.synchronize()
    assert LAUNCHES["selective_scan"] == 1 and y.dtype == y_dtype
    want_y, want_h = selective_scan_ref(*args, out_dtype=y_dtype)
    assert float((y.float() - want_y.float()).abs().max()) <= atol
    assert float((h - want_h).abs().max()) <= 1e-4


@pytest.mark.parametrize("x_dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("b,s,di,n", [
    (1, 4100, 64, 16),  # 65 chunks of 64 steps, the last ragged
    (2, 2048, 256, 16),  # falcon-mamba's prefill batch and length
    (1, 1, 64, 16),
    (2, 100, 40, 1), (2, 100, 40, 4), (2, 100, 40, 8), (2, 100, 40, 16), (2, 100, 40, 32),
])
def test_scan_kernel_long_and_every_state_size(cuda, x_dtype, b, s, di, n):
    """Lengths across and inside the kernel's chunks and every state size,
    y in f32 as the Mamba1 block asks for it (a bf16 y of these lengths
    reaches |y| > 16, where one bf16 step is 0.125)."""
    g = np.random.default_rng(s + n)
    dt = torch.from_numpy(np.log1p(np.exp(g.standard_normal((b, s, di)))).astype(np.float32))
    A_log = torch.from_numpy(np.log(np.abs(g.standard_normal((di, n))) + 0.5).astype(np.float32))
    args = [t.to(cuda) for t in (dt, _normal((b, s, n), 5), _normal((b, s, n), 6),
                                 _normal((b, s, di), 7).to(x_dtype), A_log, _normal((di,), 8))]
    reset_launches()
    y, h = selective_scan_op(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert LAUNCHES["selective_scan"] == 1
    want_y, want_h = selective_scan_ref(*args, out_dtype=torch.float32)
    assert float((y - want_y).abs().max()) <= 1e-4
    assert float((h - want_h).abs().max()) <= 1e-4


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma2-2b", "granite-3-2b", "falcon-mamba-7b"])
def test_model_forward_on_card_matches_cpu(cuda, arch):
    """The f32 smoke forward and a decode step through the kernels on the
    card against the plain path on the CPU, on the same params."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Batch, build_model

    cfg = get_arch(arch).smoke_variant()
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device="cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    params_card = tree_map(lambda t: t.to(cuda), params)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 160)))
    reset_launches()
    got, _ = card.forward(params_card, Batch(tokens=tokens.to(cuda)))
    torch.cuda.synchronize()
    kernel = "selective_scan" if cfg.family == "ssm" else "flash_attention"
    assert LAUNCHES[kernel] == cfg.n_layers
    want, _ = cpu.forward(params, Batch(tokens=tokens))
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    cache = card.init_cache(2, 32)
    step, _ = card.decode_step(params_card, tokens[:, :1].to(cuda),
                               torch.zeros(2, dtype=torch.long, device=cuda), cache)
    assert float((step[:, 0].cpu() - want[:, 0]).abs().max()) <= 5e-2


def test_long_context_ring_decode_on_card_matches_cpu(cuda):
    """granite-3-2b's ``long_500k`` smoke variant (every layer windowed at
    128, each cache a ring of 128): 160 decode steps on the card, the ring
    wrapping, against the same steps on the CPU's plain path on the same
    params, and the card's last logits against its own windowed forward."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Batch, build_model

    cfg = get_arch("granite-3-2b").smoke_variant()
    cpu = build_model(cfg, "long_500k", device="cpu")
    card = build_model(cfg, "long_500k", device="cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    params_card = tree_map(lambda t: t.to(cuda), params)
    b, steps = 2, 160
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (b, steps)))
    c_cpu, c_card = cpu.init_cache(b, steps), card.init_cache(b, steps)
    assert c_card["kv"]["k"].shape[2] == cfg.sliding_window == 128
    worst = torch.zeros((), device=cuda)
    for t in range(steps):
        pos = torch.full((b,), t, dtype=torch.long)
        want, c_cpu = cpu.decode_step(params, tokens[:, t:t + 1], pos, c_cpu)
        got, c_card = card.decode_step(params_card, tokens[:, t:t + 1].to(cuda), pos.to(cuda),
                                       c_card)
        worst = torch.maximum(worst, (got - want.to(cuda)).abs().max())
    assert float(worst) <= 1e-4
    for name in ("k", "v"):
        assert float((c_card["kv"][name].cpu() - c_cpu["kv"][name]).abs().max()) <= 1e-5
    reset_launches()
    full, _ = card.forward(params_card, Batch(tokens=tokens.to(cuda)))
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == cfg.n_layers
    assert float((got[:, 0] - full[:, -1]).abs().max()) < 5e-2


# -- the flash-attention backward and training through the kernels ----------------

from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.kernels.attention.flash import flash_attention, flash_attention_bwd  # noqa: E402
from repro_torch.kernels.attention.ref import (  # noqa: E402
    BWD_BF16_TOL,
    BWD_F32_TOL,
    attention_bwd_ref,
    attention_lse_ref,
)

BWD_CASES = [  # b, s, h, kv, hd, causal, window, softcap
    (2, 256, 4, 4, 64, True, 0, 0.0),
    (1, 200, 6, 2, 64, True, 0, 0.0),  # ragged tiles, GQA 3:1
    (1, 77, 3, 1, 32, False, 0, 0.0),
    (2, 384, 5, 5, 32, True, 256, 30.0),
    (1, 320, 4, 2, 128, True, 100, 0.0),
    (1, 300, 8, 4, 256, True, 128, 50.0),  # gemma2's head dim, window and softcap
    (2, 333, 4, 4, 128, False, 0, 0.0),
    (1, 700, 8, 4, 256, True, 150, 50.0),
    (1, 3, 4, 2, 64, True, 0, 0.0),  # row 0 sees one key: its dQ is exactly 0
    (1, 129, 4, 1, 32, True, 64, 0.0),
    (2, 1024, 15, 5, 64, True, 0, 0.0),  # smollm-360m's heads
    (1, 1000, 8, 2, 128, True, 0, 0.0),  # GQA 4:1, a length no tile divides
    (1, 1000, 6, 2, 256, True, 300, 50.0),  # GQA 3:1 at gemma2's head dim
    (2, 200, 12, 3, 32, True, 0, 0.0),
    (1, 1000, 8, 8, 64, True, 77, 0.0),  # the window's edge inside a tile
    (1, 256, 4, 1, 128, False, 0, 30.0),
    (1, 300, 4, 4, 112, True, 0, 0.0),  # zamba2's head dim, one padded 128-column split
    (2, 200, 6, 6, 112, False, 0, 0.0),
    (1, 1000, 8, 2, 160, True, 0, 0.0),  # stablelm-12b's: two 128-column splits, 96 dropped
    (1, 333, 4, 1, 160, True, 100, 30.0),
]


def _bwd_inputs(cuda, dtype, b, s, h, kv, hd, causal, window, softcap):
    q = _normal((b, s, h, hd), 11).to(dtype).to(cuda)
    k = _normal((b, s, kv, hd), 12).to(dtype).to(cuda)
    v = _normal((b, s, kv, hd), 13).to(dtype).to(cuda)
    do = _normal((b, s, h, hd), 14).to(dtype).to(cuda)
    kw = dict(causal=causal, sliding_window=window, softcap=softcap)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    return q, k, v, out, lse, do, kw


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,softcap", BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, dtype, b, s, h, kv, hd, causal, window, softcap):
    """dQ, dK and dV within BWD_F32_TOL (f32) or BWD_BF16_TOL (bf16) of each
    gradient's max |g|, against attention_bwd_ref on the same inputs; two
    runs bit-identical (no atomics)."""
    q, k, v, out, lse, do, kw = _bwd_inputs(cuda, dtype, b, s, h, kv, hd, causal, window,
                                            softcap)
    reset_launches()
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd"] == 2
    want = attention_bwd_ref(q, k, v, out, lse, do, **kw)
    tol = BWD_F32_TOL if dtype == torch.float32 else BWD_BF16_TOL
    for name, g, a, w in zip("qkv", got, again, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.equal(g, a), f"d{name} differs between two runs"
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol * max(scale, 1e-30), name


def _check_bwd(q, k, v, do, kw):
    """The backward kernel against attention_bwd_ref at the forward kernel's
    output and LSE: each gradient within its dtype's tolerance of its max
    |g|, two runs bit-identical."""
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    want = attention_bwd_ref(q, k, v, out, lse, do, **kw)
    tol = BWD_F32_TOL if q.dtype == torch.float32 else BWD_BF16_TOL
    for name, g, a, w in zip("qkv", got, again, want):
        assert torch.equal(g, a), f"d{name} differs between two runs"
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol * max(scale, 1e-30), name


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("s_q,s_kv", [(200, 333), (333, 200)])
@pytest.mark.parametrize("hd,causal,window,softcap", [
    (64, True, 0, 0.0), (64, False, 0, 0.0), (256, True, 100, 50.0), (128, False, 0, 0.0)])
def test_flash_bwd_kernel_more_keys_or_queries(cuda, dtype, s_q, s_kv, hd, causal, window,
                                               softcap):
    """s_q != s_kv (the mask compares positions as the forward does: key j
    visible to query i where j <= i and j > i - window), GQA 3:1."""
    q = _normal((1, s_q, 6, hd), 21).to(dtype).to(cuda)
    k = _normal((1, s_kv, 2, hd), 22).to(dtype).to(cuda)
    v = _normal((1, s_kv, 2, hd), 23).to(dtype).to(cuda)
    do = _normal((1, s_q, 6, hd), 24).to(dtype).to(cuda)
    _check_bwd(q, k, v, do, dict(causal=causal, sliding_window=window, softcap=softcap))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("hd,kv", [(64, 1), (256, 2)])
def test_flash_bwd_kernel_scores_near_the_cap(cuda, dtype, hd, kv):
    """q x 25 puts the scores' spread at half the cap of 50, where the
    softcap's chain factor 1 - tanh^2 is far from 1."""
    q = (25 * _normal((1, 640, 4, hd), 31)).to(dtype).to(cuda)
    k = _normal((1, 640, kv, hd), 32).to(dtype).to(cuda)
    v = _normal((1, 640, kv, hd), 33).to(dtype).to(cuda)
    do = _normal((1, 640, 4, hd), 34).to(dtype).to(cuda)
    _check_bwd(q, k, v, do, dict(causal=True, sliding_window=256, softcap=50.0))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,softcap", BWD_CASES[:8])
def test_flash_forward_lse_and_unchanged_without_it(cuda, dtype, b, s, h, kv, hd, causal,
                                                    window, softcap):
    """With a null LSE pointer the output is bit-identical to the output
    with one; the LSE within 1e-4 of the plain version's."""
    q, k, v, out, lse, _, kw = _bwd_inputs(cuda, dtype, b, s, h, kv, hd, causal, window,
                                           softcap)
    plain_out = flash_attention(q, k, v, **kw)
    assert torch.equal(plain_out, out)
    _, want = attention_lse_ref(q, k, v, **kw)
    assert float((lse - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


def test_autograd_reaches_q_k_v_projections_through_the_kernels(cuda):
    """P3: on the card, gradients of wq, wk and wv come through the
    backward kernel and equal those of the plain attention."""
    from repro_torch.models import attention as pt_attn

    g = torch.Generator().manual_seed(0)
    params = pt_attn.init_attention(g, 128, 4, 2, 32, torch.float32)
    params = {n: w.to(cuda).requires_grad_() for n, w in params.items()}
    x = _normal((2, 96, 128), 5).to(cuda)
    pos = torch.arange(96, device=cuda).expand(2, 96)
    reset_launches()
    loss = pt_attn.attention(params, x, pos, causal=True).square().sum()
    grads = torch.autograd.grad(loss, [params[n] for n in ("wq", "wk", "wv", "wo")])
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    assert launch_counts()["flash_attention_bwd"] == 1
    cpu = {n: w.detach().cpu().requires_grad_() for n, w in params.items()}
    # the same attention through the masked einsum route, differentiated by autograd
    q = pt_attn.apply_rope(pt_attn.project_heads(x.cpu(), cpu["wq"]), pos.cpu())
    k = pt_attn.apply_rope(pt_attn.project_heads(x.cpu(), cpu["wk"]), pos.cpu())
    v = pt_attn.project_heads(x.cpu(), cpu["wv"])
    mask = torch.ones(96, 96, dtype=torch.bool).tril().expand(2, 96, 96)
    o = pt_attn._attend_masked(q, pt_attn._expand_kv(k, 4), pt_attn._expand_kv(v, 4), mask, 0.0)
    ref_loss = pt_attn.merge_heads(o, cpu["wo"]).square().sum()
    want = torch.autograd.grad(ref_loss, [cpu[n] for n in ("wq", "wk", "wv", "wo")])
    for got_g, want_g in zip(grads, want):
        assert float(got_g.abs().max()) > 0
        assert float((got_g.cpu() - want_g).abs().max()) <= 1e-4 * float(want_g.abs().max())


SCAN_BWD_CASES = [  # b, s, di, n
    (2, 64, 64, 16),  # one chunk, one block of channels
    (2, 100, 70, 1),  # ragged chunk and block, one state
    (2, 200, 130, 32),  # n = 32: sixteen groups of two states
    (2, 17, 24, 16),  # shorter than a chunk, fewer channels than a warp row
    (2, 130, 192, 16),  # three whole blocks, three chunks
    (2, 63, 64, 16),  # one step short of a chunk: the last segment ragged
    (2, 65, 64, 16),  # one step past a chunk
    (2, 100, 68, 16),  # 4 channels past a block: half a warp of the second live
    (2, 130, 96, 17),  # an odd state count: a padding state
    (1, 2048, 512, 32),  # n = 32 at length 2048: the most shared memory a block takes
]


def _scan_bwd_inputs(cuda, b, s, di, n, x_dtype, with_dh, seed=0, mamba_init=False):
    """With ``mamba_init``, Mamba's initialization: dt log-uniform in [1e-3,
    1e-1] and A = -(1 .. n), states that live for hundreds of steps."""
    g = np.random.default_rng(seed + s + n)
    dt = torch.from_numpy(np.log1p(np.exp(g.standard_normal((b, s, di)))).astype(np.float32))
    A_log = torch.from_numpy(np.log(np.abs(g.standard_normal((di, n))) + 0.5).astype(np.float32))
    if mamba_init:
        dt = torch.from_numpy(np.exp(g.uniform(np.log(1e-3), np.log(1e-1), (b, s, di)))
                              .astype(np.float32))
        A_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32)).expand(di, n).contiguous()
    args = [t.to(cuda) for t in (dt, _normal((b, s, n), 5), _normal((b, s, n), 6),
                                 _normal((b, s, di), 7).to(x_dtype), A_log, _normal((di,), 8))]
    dy = _normal((b, s, di), 9).to(cuda)
    dh = _normal((b, di, n), 10).to(cuda) if with_dh else None
    return args, dy, dh


@pytest.mark.parametrize("with_dh", (False, True), ids=("dh_zero", "dh_nonzero"))
@pytest.mark.parametrize("x_dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("b,s,di,n", SCAN_BWD_CASES)
def test_scan_bwd_kernel_matches_plain(cuda, x_dtype, with_dh, b, s, di, n):
    """Every gradient within SCAN_BWD_TOL of its max |g| of
    selective_scan_bwd_ref on the same inputs (a bf16 dx within
    SCAN_BWD_BF16_TOL), two runs bit-identical; the forward's y the same
    bits with and without its chunk states."""
    args, dy, dh = _scan_bwd_inputs(cuda, b, s, di, n, x_dtype, with_dh)
    y0, _ = mamba_selective_scan(*args, torch.float32)
    reset_launches()
    y, _, hc = mamba_selective_scan(*args, torch.float32, return_chunk_states=True)
    got = selective_scan_bwd(*args, hc, dy, dh)
    again = selective_scan_bwd(*args, hc, dy, dh)
    torch.cuda.synchronize()
    assert torch.equal(y, y0) and hc.shape == (b, -(-s // 64), di, n)
    assert launch_counts()["selective_scan_bwd"] == 2
    want = selective_scan_bwd_ref(*args, dy, dh)
    for name, g1, g2, w in zip(("ddt", "dB", "dC", "dx", "dA_log", "dD"), got, again, want):
        assert torch.equal(g1, g2), name
        assert g1.dtype == w.dtype and g1.shape == w.shape, name
        tol = SCAN_BWD_BF16_TOL if g1.dtype == torch.bfloat16 else SCAN_BWD_TOL
        err, scale = float((g1.float() - w.float()).abs().max()), float(w.float().abs().max())
        assert err <= tol * scale, f"{name}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("x_dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("b,s,di,n", [(2, 200, 70, 16), (1, 130, 68, 17), (1, 2048, 256, 32)])
def test_scan_bwd_kernel_matches_plain_at_mamba_init(cuda, x_dtype, b, s, di, n):
    """As test_scan_bwd_kernel_matches_plain, from Mamba's initialization:
    states live for hundreds of steps, so a wrong carry between segments or
    chunks cannot hide in the decay."""
    args, dy, dh = _scan_bwd_inputs(cuda, b, s, di, n, x_dtype, True, mamba_init=True)
    _, _, hc = mamba_selective_scan(*args, torch.float32, return_chunk_states=True)
    got = selective_scan_bwd(*args, hc, dy, dh)
    again = selective_scan_bwd(*args, hc, dy, dh)
    torch.cuda.synchronize()
    want = selective_scan_bwd_ref(*args, dy, dh)
    for name, g1, g2, w in zip(("ddt", "dB", "dC", "dx", "dA_log", "dD"), got, again, want):
        assert torch.equal(g1, g2), name
        tol = SCAN_BWD_BF16_TOL if g1.dtype == torch.bfloat16 else SCAN_BWD_TOL
        err, scale = float((g1.float() - w.float()).abs().max()), float(w.float().abs().max())
        assert err <= tol * scale, f"{name}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("b,s,di,n", [(0, 10, 8, 4), (2, 10, 0, 4), (2, 0, 8, 4)])
def test_scan_bwd_kernel_empty_shapes(cuda, b, s, di, n):
    """No batch rows, channels or steps: every gradient is a sum over
    nothing, so it equals the plain version's zeros exactly."""
    args, dy, dh = _scan_bwd_inputs(cuda, b, s, di, n, torch.float32, False)
    _, _, hc = mamba_selective_scan(*args, torch.float32, return_chunk_states=True)
    got = selective_scan_bwd(*args, hc, dy, dh)
    want = selective_scan_bwd_ref(*args, dy, dh)
    for name, g, w in zip(("ddt", "dB", "dC", "dx", "dA_log", "dD"), got, want):
        assert g.shape == w.shape and torch.equal(g, w), name


def test_scan_chunk_states_match_the_blocked_forward(cuda):
    """The forward kernel's chunk states against the plain decomposition's."""
    args, _, _ = _scan_bwd_inputs(cuda, 2, 300, 40, 8, torch.float32, False)
    _, _, hc = mamba_selective_scan(*args, torch.float32, return_chunk_states=True)
    _, _, want = selective_scan_blocked(*args, return_chunk_states=True)
    assert float((hc - want).abs().max()) <= 1e-4 * max(1.0, float(want.abs().max()))


def test_scan_autograd_on_card_goes_through_the_backward_kernel(cuda):
    """P3, closed by B6b: with a gradient asked for, the op runs the
    SelectiveScan Function, the forward kernel and the backward kernel once
    each, and its gradients equal the CPU's (the plain versions); without a
    gradient it launches the forward alone."""
    b, s, di, n = 2, 100, 48, 16
    args, dy, dh = _scan_bwd_inputs(cuda, b, s, di, n, torch.float32, True, seed=3)
    leaves = [t.clone().requires_grad_() for t in args]
    reset_launches()
    y, h = selective_scan_op(*leaves, out_dtype=torch.float32)
    grads = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), leaves)
    torch.cuda.synchronize()
    assert launch_counts()["selective_scan"] == 1 and launch_counts()["selective_scan_bwd"] == 1
    cpu = [t.detach().cpu().requires_grad_() for t in args]
    yc, hc_ = selective_scan_op(*cpu, out_dtype=torch.float32)
    want = torch.autograd.grad((yc * dy.cpu()).sum() + (hc_ * dh.cpu()).sum(), cpu)
    for g, w in zip(grads, want):
        assert float((g.cpu() - w).abs().max()) <= SCAN_BWD_TOL * float(w.abs().max())
    reset_launches()
    with torch.no_grad():
        y, _ = selective_scan_op(*leaves, out_dtype=torch.float32)
    assert y.grad_fn is None and launch_counts()["selective_scan"] == 1
    assert launch_counts()["selective_scan_bwd"] == 0


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_mamba1_block_grads_on_card_match_cpu(cuda, dtype):
    """A Mamba1 block's gradients through the kernels on the card against
    the same block's on the CPU (the plain versions), on the same weights:
    every leaf within 1e-4 of its max |g| in f32; in bf16 the card's are
    held to the CPU's f32 gradients of the same bf16 weights within 5e-2."""
    from repro_torch.models import mamba as pt_mamba

    d_model, d_inner, n, rank = 64, 128, 16, 4
    params = pt_mamba.init_mamba1(torch.Generator().manual_seed(0), d_model, d_inner, n, rank,
                                  4, dtype)
    x = _normal((2, 150, d_model), 11).to(dtype)
    w = _normal((2, 150, d_model), 12)
    names = sorted(params)

    def grads(dev, leaf_dtype):
        p = {k: v.to(dev, leaf_dtype if v.dtype == dtype else v.dtype).requires_grad_()
             for k, v in params.items()}
        xx = x.to(dev, leaf_dtype).requires_grad_()
        out = pt_mamba.mamba1_forward(p, xx, n, rank)
        return torch.autograd.grad((out.float() * w.to(dev)).sum(), [p[k] for k in names] + [xx])

    reset_launches()
    got = grads(cuda, dtype)
    torch.cuda.synchronize()
    assert launch_counts()["selective_scan"] == 1 and launch_counts()["selective_scan_bwd"] == 1
    want = grads("cpu", torch.float32)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for name, g, wg in zip(names + ["x"], got, want):
        err = float((g.float().cpu() - wg).abs().max())
        assert err <= tol * float(wg.abs().max()), f"d{name}: {err}"


def test_ssm_train_loss_grads_on_card_match_cpu(cuda):
    """falcon-mamba's f32 smoke variant: train_loss gradients through the
    scan kernels on the card against the CPU's, every leaf within 1e-4 of
    its max |g|; one forward and one backward launch a layer."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Batch, build_model

    cfg = get_arch("falcon-mamba-7b").smoke_variant()
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    g = np.random.default_rng(2)
    tok = torch.from_numpy(g.integers(0, cfg.vocab, (2, 130)))
    lab = torch.from_numpy(g.integers(0, cfg.vocab, (2, 130)))

    def grads(dev):
        p = tree_map(lambda t: t.to(dev).requires_grad_(), params)
        loss = build_model(cfg, device=dev).train_loss(
            p, Batch(tokens=tok.to(dev), labels=lab.to(dev)))
        return torch.autograd.grad(loss, tree_leaves(p))

    reset_launches()
    got = grads(cuda)
    torch.cuda.synchronize()
    assert launch_counts()["selective_scan"] == cfg.n_layers
    assert launch_counts()["selective_scan_bwd"] == cfg.n_layers
    assert launch_counts()["flash_attention"] == 0
    for gc, wc in zip(got, grads("cpu")):
        assert float((gc.cpu() - wc).abs().max()) <= 1e-4 * float(wc.abs().max())


def test_scan_bwd_kernel_rejects_bad_inputs(cuda):
    args, dy, dh = _scan_bwd_inputs(cuda, 1, 70, 16, 4, torch.float32, True)
    _, _, hc = mamba_selective_scan(*args, torch.float32, return_chunk_states=True)
    with pytest.raises(ValueError, match="h_chunks"):
        selective_scan_bwd(*args, hc[:, :1], dy, dh)
    with pytest.raises(ValueError, match="dy"):
        selective_scan_bwd(*args, hc, dy[:, :5], dh)
    with pytest.raises(ValueError, match="dh_last"):
        selective_scan_bwd(*args, hc, dy, dh.double())
    with pytest.raises(ValueError, match="CUDA"):
        selective_scan_bwd(*args, hc, dy.cpu(), dh)


# -- the moe family on the card ------------------------------------------------------

@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("h,kv", [(32, 4), (56, 8)], ids=["qwen3-moe", "arctic"])
def test_flash_kernels_at_the_moe_head_groups(cuda, dtype, h, kv):
    """hd 128 with GQA groups of 8 and 7, the moe configs' heads: the
    forward and the backward against their plain versions."""
    q = _normal((1, 320, h, 128), 41).to(dtype).to(cuda)
    k = _normal((1, 320, kv, 128), 42).to(dtype).to(cuda)
    v = _normal((1, 320, kv, 128), 43).to(dtype).to(cuda)
    out = flash_attention_op(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    assert float((out.float() - want.float()).abs().max()) <= atol
    if dtype == torch.bfloat16:
        assert rounding_units(out, q, k, v, causal=True) <= BF16_UNITS_TOL
    do = _normal((1, 320, h, 128), 44).to(dtype).to(cuda)
    _check_bwd(q, k, v, do, dict(causal=True, sliding_window=0, softcap=0.0))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("h,kv,hd", [(32, 8, 160), (32, 32, 112)], ids=["stablelm", "zamba2"])
def test_flash_kernels_at_the_new_head_dims(cuda, dtype, h, kv, hd):
    """stablelm-12b's and zamba2-7b's heads at their head dims: the forward
    and the backward against their plain versions, every gradient column
    (the backward's dropped padding columns must not reach dQ, dK or dV)."""
    q = _normal((1, 384, h, hd), 51).to(dtype).to(cuda)
    k = _normal((1, 384, kv, hd), 52).to(dtype).to(cuda)
    v = _normal((1, 384, kv, hd), 53).to(dtype).to(cuda)
    out = flash_attention_op(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    assert out.shape == q.shape and float((out.float() - want.float()).abs().max()) <= atol
    if dtype == torch.bfloat16:
        assert rounding_units(out, q, k, v, causal=True) <= BF16_UNITS_TOL
    do = _normal((1, 384, h, hd), 54).to(dtype).to(cuda)
    _check_bwd(q, k, v, do, dict(causal=True, sliding_window=0, softcap=0.0))


@pytest.mark.parametrize("arch,head_dim", [("stablelm-12b", 160), ("zamba2-7b", 112)])
def test_new_archs_on_card_match_cpu_at_their_head_dims(cuda, arch, head_dim):
    """The f32 smoke variants at their own head dims (zamba2 with two
    super-blocks and a tail): the forward through the kernels on the card
    (one flash launch a dense layer or a use of the shared block, no scan)
    and every gradient leaf against the plain path on the CPU, same params;
    a decode step against the forward."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Batch, build_model

    cfg = get_arch(arch).smoke_variant().replace(head_dim=head_dim)
    if cfg.family == "hybrid":
        cfg = cfg.replace(n_layers=5, attn_every=2)
    cpu, card = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    params_card = tree_map(lambda t: t.to(cuda).requires_grad_(), params)
    params = tree_map(lambda t: t.requires_grad_(), params)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 160)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 160)))
    reset_launches()
    loss = card.train_loss(params_card, Batch(tokens=tokens.to(cuda), labels=labels.to(cuda)))
    got = torch.autograd.grad(loss, tree_leaves(params_card))
    torch.cuda.synchronize()
    n_attn = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers
    assert launch_counts()["flash_attention"] == n_attn
    assert launch_counts()["flash_attention_bwd"] == n_attn
    assert launch_counts()["selective_scan"] == 0
    want_loss = cpu.train_loss(params, Batch(tokens=tokens, labels=labels))
    want = torch.autograd.grad(want_loss, tree_leaves(params))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-30)
    with torch.no_grad():
        full, _ = card.forward(params_card, Batch(tokens=tokens.to(cuda)))
        step, _ = card.decode_step(params_card, tokens[:, :1].to(cuda),
                                   torch.zeros(2, dtype=torch.long, device=cuda),
                                   card.init_cache(2, 32))
    assert float((step[:, 0] - full[:, 0]).abs().max()) <= 5e-2


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b"])
def test_moe_model_on_card_matches_cpu(cuda, arch):
    """The f32 smoke forward (aux included) and a decode step through the
    kernels on the card against the plain path on the CPU, same params."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Batch, build_model

    cfg = get_arch(arch).smoke_variant()
    cpu, card = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    params_card = tree_map(lambda t: t.to(cuda), params)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 160)))
    reset_launches()
    got, aux = card.forward(params_card, Batch(tokens=tokens.to(cuda)))
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == cfg.n_layers
    want, want_aux = cpu.forward(params, Batch(tokens=tokens))
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    assert abs(float(aux) - float(want_aux)) <= 1e-5
    step, _ = card.decode_step(params_card, tokens[:, :1].to(cuda),
                               torch.zeros(2, dtype=torch.long, device=cuda),
                               card.init_cache(2, 32))
    assert float((step[:, 0].cpu() - want[:, 0]).abs().max()) <= 5e-2


def test_moe_decode_step_replays_as_a_cuda_graph(cuda):
    """No host sync and no data-dependent shape in a moe decode step: it
    captures, and the replay gives the eager step's logits."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = get_arch("qwen3-moe-30b-a3b").smoke_variant().replace(dtype="bfloat16")
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    cache = model.init_cache(4, 32)
    tok = torch.randint(0, cfg.vocab, (4, 1), device=cuda)
    pos = torch.full((4,), 3, dtype=torch.long, device=cuda)
    with torch.inference_mode():
        eager, _ = model.decode_step(params, tok, pos, cache)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            model.decode_step(params, tok, pos, cache)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, _ = model.decode_step(params, tok, pos, cache)
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_moe_train_step_on_card_routes_alike(cuda):
    """One DFL step of the qwen3-moe smoke variant in bf16 on 4 stacked
    nodes: the routing pass and the differentiated pass give equal f counts,
    and each flash kernel launches once a layer a node in each pass."""
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, FederatedData
    from repro_torch.dfl.trainer import DFLConfig, DFLTrainer
    from repro_torch.models import Batch, build_model

    cfg = get_arch("qwen3-moe-30b-a3b").smoke_variant().replace(dtype="bfloat16")
    model = build_model(cfg, device="cuda")
    trainer = DFLTrainer(model, 4, DFLConfig(lr=1e-3, warmup=0), device="cuda")
    state = trainer.init_state(torch.Generator(device=cuda).manual_seed(0))
    tok, lab = FederatedData(DataConfig(vocab=cfg.vocab, seq_len=256, batch_per_node=2,
                                        n_nodes=4)).global_batch()
    reset_launches()
    state, m = trainer.train_step(state, Batch(tokens=torch.from_numpy(tok).long().to(cuda),
                                               labels=torch.from_numpy(lab).long().to(cuda)))
    torch.cuda.synchronize()
    assert float(m["route_mismatch"]) == 0.0 and np.isfinite(float(m["loss"]))
    assert launch_counts()["flash_attention"] == 2 * cfg.n_layers * 4
    assert launch_counts()["flash_attention_bwd"] == cfg.n_layers * 4


def test_hybrid_decode_step_replays_as_a_cuda_graph(cuda):
    """The hybrid's decode step (Mamba2 state updates and the shared block's
    caches) captures, and the replay gives the eager step's logits."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = get_arch("zamba2-7b").smoke_variant().replace(dtype="bfloat16", n_layers=5)
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    cache = model.init_cache(4, 32)
    tok = torch.randint(0, cfg.vocab, (4, 1), device=cuda)
    pos = torch.full((4,), 3, dtype=torch.long, device=cuda)
    with torch.inference_mode():
        eager, _ = model.decode_step(params, tok, pos, cache)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            model.decode_step(params, tok, pos, cache)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, _ = model.decode_step(params, tok, pos, cache)
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


# -- whisper-tiny and paligemma-3b on the card ----------------------------------------

@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("s,causal", [(320, True), (40, False)], ids=["causal", "prefix"])
def test_flash_kernels_at_paligemma_mqa_hd256(cuda, dtype, s, causal):
    """paligemma's heads, shrunk: hd 256 at GQA 8:1 (MQA), the two calls of
    the prefix split (a causal one over every row, a non-causal one over a
    40-row prefix, which no tile divides). The forward against its plain
    version, and the backward, whose dK / dV blocks sum 8 query heads."""
    q = _normal((1, s, 8, 256), 61).to(dtype).to(cuda)
    k = _normal((1, s, 1, 256), 62).to(dtype).to(cuda)
    v = _normal((1, s, 1, 256), 63).to(dtype).to(cuda)
    out = flash_attention_op(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    assert float((out.float() - want.float()).abs().max()) <= atol
    if dtype == torch.bfloat16:
        assert rounding_units(out, q, k, v, causal=causal) <= BF16_UNITS_TOL
    do = _normal((1, s, 8, 256), 64).to(dtype).to(cuda)
    _check_bwd(q, k, v, do, dict(causal=causal, sliding_window=0, softcap=0.0))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("s_q,s_kv", [(375, 375), (100, 375), (1, 375)],
                         ids=["encoder", "cross", "decode"])
def test_flash_kernels_non_causal_over_a_ragged_kv(cuda, dtype, s_q, s_kv):
    """whisper's attentions, shrunk: non-causal over 375 keys (1500 / 4, no
    tile divides it), self (the encoder), from 100 queries (the decoder's
    cross-attention) and from one (a decode step's). The forward against its
    plain version, and the backward."""
    q = _normal((2, s_q, 6, 64), 71).to(dtype).to(cuda)
    k = _normal((2, s_kv, 6, 64), 72).to(dtype).to(cuda)
    v = _normal((2, s_kv, 6, 64), 73).to(dtype).to(cuda)
    out = flash_attention_op(q, k, v, causal=False)
    want = attention_ref(q, k, v, causal=False)
    atol = 2e-5 if dtype == torch.float32 else 2e-2
    assert out.shape == q.shape and float((out.float() - want.float()).abs().max()) <= atol
    if dtype == torch.bfloat16:
        assert rounding_units(out, q, k, v, causal=False) <= BF16_UNITS_TOL
    do = _normal((2, s_q, 6, 64), 74).to(dtype).to(cuda)
    _check_bwd(q, k, v, do, dict(causal=False, sliding_window=0, softcap=0.0))


@pytest.mark.parametrize("arch", ["whisper-tiny", "paligemma-3b"])
def test_frontend_archs_on_card_match_cpu(cuda, arch):
    """The f32 smoke variants with seeded frames or patches: the loss and
    every gradient leaf through the kernels on the card against the plain
    path on the CPU, same params (flash forward and backward launches:
    whisper's encoder layers plus two a decoder layer, two a paligemma
    layer); whisper's decode step with the cross cache filled from
    ``Model.encode`` against the forward."""
    from repro_torch.configs import get_arch
    from repro_torch.models import Batch, build_model
    from repro_torch.models.attention import project_heads

    cfg = get_arch(arch).smoke_variant()
    cpu, card = build_model(cfg, device="cpu"), build_model(cfg, device="cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    params_card = tree_map(lambda t: t.to(cuda).requires_grad_(), params)
    params = tree_map(lambda t: t.requires_grad_(), params)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 160)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 160)))
    key, n_rows = (("encoder_frames", cfg.n_frames) if cfg.family == "audio"
                   else ("patch_embeddings", cfg.n_patches))
    front = _normal((2, n_rows, cfg.d_model), 2)
    reset_launches()
    loss = card.train_loss(params_card, Batch(tokens=tokens.to(cuda), labels=labels.to(cuda),
                                              **{key: front.to(cuda)}))
    got = torch.autograd.grad(loss, tree_leaves(params_card))
    torch.cuda.synchronize()
    n_flash = (cfg.n_encoder_layers + 2 * cfg.n_layers if cfg.family == "audio"
               else 2 * cfg.n_layers)
    assert launch_counts()["flash_attention"] == n_flash
    assert launch_counts()["flash_attention_bwd"] == n_flash
    want_loss = cpu.train_loss(params, Batch(tokens=tokens, labels=labels, **{key: front}))
    want = torch.autograd.grad(want_loss, tree_leaves(params))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-30)
    if cfg.family != "audio":
        return
    with torch.no_grad():
        full, _ = card.forward(params_card, Batch(tokens=tokens.to(cuda),
                                                  encoder_frames=front.to(cuda)))
        enc = card.encode(params_card, front.to(cuda))
        cross = params_card["blocks"]["cross"]
        cache = dict(card.init_cache(2, 32),
                     cross_k=torch.stack([project_heads(enc, w) for w in cross["wk"]]),
                     cross_v=torch.stack([project_heads(enc, w) for w in cross["wv"]]))
        reset_launches()
        step, _ = card.decode_step(params_card, tokens[:, :1].to(cuda),
                                   torch.zeros(2, dtype=torch.long, device=cuda), cache)
    assert launch_counts()["flash_attention"] == cfg.n_layers  # the cross-attentions
    assert float((step[:, 0] - full[:, 0]).abs().max()) <= 5e-2


def test_whisper_decode_step_replays_as_a_cuda_graph(cuda):
    """whisper's decode step launches the flash kernel for each layer's
    cross-attention (s_q 1 against the cross cache): the step captures, the
    replay launches it, and gives the eager step's logits."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = get_arch("whisper-tiny").smoke_variant().replace(dtype="bfloat16")
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    cache = model.init_cache(4, 32)
    g = torch.Generator(device=cuda).manual_seed(1)
    for n in ("cross_k", "cross_v"):
        cache[n].normal_(generator=g)
    tok = torch.randint(0, cfg.vocab, (4, 1), device=cuda)
    pos = torch.full((4,), 3, dtype=torch.long, device=cuda)
    with torch.inference_mode():
        eager, _ = model.decode_step(params, tok, pos, cache)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            model.decode_step(params, tok, pos, cache)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        reset_launches()
        with torch.cuda.graph(graph):
            out, _ = model.decode_step(params, tok, pos, cache)
        assert launch_counts()["flash_attention"] == cfg.n_layers
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


# -- the sweep path: phase 6's segmented codec shapes, a 10-node cell --------------

def _whisper_segment_shapes():
    """(rows, segment length) of every hop of whisper-tiny's leaves in the
    segmented round on the codec_x_protocol overlay (ER(10), seed 3)."""
    from repro_torch.configs import get_arch
    from repro_torch.dfl.session import plan_for_members
    from repro_torch.models import build_model
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.scenario import scenarios

    spec = scenarios.get_sweep("codec_x_protocol").cells()[1].spec
    plan = plan_for_members(spec.n, range(spec.n), n_segments=spec.n_segments,
                            full_graph=spec.overlay_graph())
    rows = sorted({len(step.perm) for step in plan.seg_steps if step.perm})
    leaves = tree_leaves(build_model(get_arch("whisper-tiny"), device="cpu").init(
        torch.Generator().manual_seed(0)))
    sizes = sorted({-(-t.numel() // spec.n_segments) for t in leaves})
    return [(r, size) for r in rows for size in sizes]


@pytest.mark.parametrize("codec", ("int8", "int4", "topk"))
def test_segmented_whisper_shapes_match_plain(cuda, codec):
    """Every (rows, segment) shape at which the segmented codec_x_protocol
    cells launch a codec kernel on whisper-tiny's leaves: bit for bit."""
    for i, (rows, size) in enumerate(_whisper_segment_shapes()):
        x = _x(rows, size, seed=i)
        if codec == "topk":
            vals, idx = topk_select_op(x.to(cuda), k=13, block=256)
            want_v, want_i = ref.topk_select_rows(x, 13, 256)
            assert torch.equal(vals.cpu(), want_v) and torch.equal(idx.cpu(), want_i)
            continue
        bits = 8 if codec == "int8" else 4
        codes, scales = quantize_op(x.to(cuda), bits=bits)
        want_c, want_s = ref.quantize_rows(x, bits, 1024)
        assert torch.equal(codes.cpu(), want_c) and torch.equal(scales.cpu(), want_s)
        out = dequantize_op(codes, scales, size=size, bits=bits)
        assert torch.equal(out.cpu(), ref.dequantize_rows(want_c, want_s, size, bits, 1024))


def test_segmented_int4_cell_from_unequal_nodes_on_card(cuda):
    """codec_x_protocol cell 7 (int4, segmented) on 10 nodes through the
    launcher at smoke width: one round from seeded unequal nodes within the
    runner's int4 tolerance of the gossip-off round's FedAvg, through the
    codec kernels and the mix."""
    import contextlib
    import io

    from repro_torch.launch import train as launcher
    from repro_torch.scenario.runner import fedavg_check

    args = launcher.parse_args(["--arch", "whisper-tiny", "--smoke", "--nodes", "10",
                                "--seq-len", "32", "--sweep", "codec_x_protocol",
                                "--cell", "7"])
    with contextlib.redirect_stdout(io.StringIO()):
        _, spec = launcher.resolve_scenario(args)
    run = launcher.build_run(args, spec)
    assert run.trainer.device.type == "cuda"
    reset_launches()
    ok, finite, worst, times = fedavg_check(run.trainer, run.state, run.make_batch(),
                                            session=run.session)
    assert ok is True and finite, worst
    for name in ("quantize", "dequantize", "gossip_mix", "flash_attention"):
        assert LAUNCHES[name] > 0, name


@pytest.mark.parametrize("cell", (1, 3))
def test_runner_plans_over_the_annealed_overlay_on_card(cuda, cell):
    """An optimized_vs_mst optimizer cell on the card at a proxy width: the
    device plan is the one over the plan cache's annealed overlay, every
    round holds the FedAvg, and the mix launched."""
    from repro_torch.dfl.session import plan_for_members
    from repro_torch.scenario import DeviceExecutor, run_scenario, scenarios
    from repro_torch.scenario.cache import PlanCache

    spec = scenarios.get_sweep("optimized_vs_mst").cells()[cell].spec
    cache = PlanCache()
    reset_launches()
    ex = DeviceExecutor(device="cuda", proxy_elems=4096)
    run_scenario(spec, executor=ex, plan_cache=cache)
    run = ex.run
    want = plan_for_members(spec.n, range(spec.n), n_segments=spec.n_segments,
                            full_graph=cache.overlay(spec))
    (plan,) = run.plans
    np.testing.assert_array_equal(plan.mst.adj, want.mst.adj)
    assert [s.perm for s in plan.diss_steps] == [s.perm for s in want.diss_steps]
    assert all(r.numerics_ok is True and r.finite and r.device_ms is not None
               for r in run.rounds)
    assert LAUNCHES["gossip_mix"] > 0 and cache.counters["opt_misses"] == 1


def test_device_executor_sweep_on_card(cuda):
    """``run_sweep`` through the card executor at a proxy width: every
    cell's rounds equal the CPU run's, each round is timed, a traced sweep
    counts the rounds' device time as ``device.round_ms``, and every gossip
    kernel launched."""
    from repro_torch import obs
    from repro_torch.scenario import DeviceExecutor, run_sweep, scenarios

    sweep = scenarios.get_sweep("codec_x_protocol")
    ex = DeviceExecutor(proxy_elems=4096)
    reset_launches()
    with obs.recording(obs.Recorder()):
        got = run_sweep(sweep, executor=ex)
    want = run_sweep(sweep, executor=DeviceExecutor(device="cpu", proxy_elems=4096))
    assert len(got.cells) == len(ex.runs) == 10
    for cell, cpu, run in zip(got.cells, want.cells, ex.runs):
        assert cell.result.to_dict()["rounds_detail"] == cpu.result.to_dict()["rounds_detail"]
        assert all(r.finite and r.device_ms > 0 for r in run.rounds)
        assert run.device.startswith("cuda") and run.peak_bytes > 0
        traced = cell.result.report["counters"]["device.round_ms"]
        assert traced == pytest.approx(sum(r.device_ms for r in run.rounds), rel=1e-9)
    for name in ("quantize", "dequantize", "topk_select", "gossip_mix"):
        assert LAUNCHES[name] > 0, name


def test_device_executor_defaults_to_the_card(cuda):
    """The registry's ``device`` (the reference's ``jax``) runs on the card
    at the payload's full width."""
    from repro_torch.scenario import executors, run_scenario

    ex = executors.get("jax")
    res = run_scenario("quantized_table3", executor=ex)
    assert res.executor == "device" and ex.run.device.startswith("cuda")
    assert ex.run.elems_per_node == 5_300_000 and res.rounds[0].numerics_ok is True
    assert res.rounds[0].bytes_on_wire_mb == 478.86336
