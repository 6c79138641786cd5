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
    from repro_torch.scenario import run_scenario

    for name in ("quantized_table3", "mesh_smoke", "topk_sweep"):
        a = run_scenario(name, device="cuda", proxy_elems=4)
        b = run_scenario(name, device="cpu", proxy_elems=4)
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
from repro_torch.kernels.scan.ops import selective_scan_op  # noqa: E402
from repro_torch.kernels.scan.ref import selective_scan_ref  # noqa: E402


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


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_flash_kernel_reads_strided_heads(cuda, dtype, atol):
    """q, k and v as views into one fused (b, s, H + 2 KV, hd) projection (in
    bf16, TMA reads them through their strides)."""
    qkv = _normal((2, 130, 8 + 2 + 2, 64), 4).to(dtype).to(cuda)
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


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma2-2b", "falcon-mamba-7b"])
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


# -- the flash-attention backward and training through the kernels ----------------

from repro_torch.kernels import launch_counts  # noqa: E402
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


def test_scan_raises_where_autograd_needs_its_gradient(cuda):
    """P3: the scan kernel has no backward; asked for one it raises instead
    of returning a y with no graph. Without a gradient it runs."""
    b, s, di, n = 1, 16, 32, 4
    args = [_normal((b, s, di), 1).abs().to(cuda), _normal((b, s, n), 2).to(cuda),
            _normal((b, s, n), 3).to(cuda), _normal((b, s, di), 4).to(cuda),
            _normal((di, n), 5).to(cuda), _normal((di,), 6).to(cuda)]
    args[3].requires_grad_()
    with pytest.raises(NotImplementedError, match="B6b"):
        selective_scan_op(*args, out_dtype=torch.float32)
    with torch.no_grad():
        y, _ = selective_scan_op(*args, out_dtype=torch.float32)
    assert y.grad_fn is None and bool(torch.isfinite(y).all())
