"""The port's codec path (plain versions, on the CPU) against the JAX package.

Three references: the Pallas kernels through ``repro.kernels.codec.ops``
(interpret mode off the TPU), ``topk_select_ref`` and
``topk_select_blocks(interpret=True)`` for top-k, and the numpy host
encoders ``_encode_leaf`` / ``_decode_leaf``. Codes, scales, values and
indices must be bit-identical, with one stated exception: on the CPU, XLA
turns the Pallas quantizer's ``absmax / qmax`` into a reciprocal multiply,
so its scales may sit 1 ulp from the true divide that the numpy encoder and
the port compute. The wire-byte model and the error bound must equal the
JAX package's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.compress import make_codec as jax_make_codec  # noqa: E402
from repro.kernels.codec.ops import dequantize_op as jax_dequantize_op  # noqa: E402
from repro.kernels.codec.ops import quantize_op as jax_quantize_op  # noqa: E402
from repro.kernels.codec.ref import topk_select_ref as jax_topk_ref  # noqa: E402
from repro.kernels.codec.topk_pack import topk_select_blocks  # noqa: E402
from repro_torch.compress import codec as codec_module  # noqa: E402
from repro_torch.compress import make_codec  # noqa: E402
from repro_torch.kernels.codec import ref  # noqa: E402
from repro_torch.kernels.codec.group import group_layout  # noqa: E402
from repro_torch.kernels.codec.ops import (  # noqa: E402
    dequantize_group_op,
    dequantize_op,
    quantize_op,
    topk_scatter,
    topk_select_op,
)

SIZES = (1, 255, 1000, 1027, 3050, 4096)  # most not a multiple of chunk / block


def _x(size, seed=0, ties=False):
    rng = np.random.default_rng(seed + size)
    x = rng.normal(size=size).astype(np.float32) * 3
    if ties:  # exact .5 multiples of the scale and repeated magnitudes
        x = (np.round(x * 4) / 4).astype(np.float32)
        x[: size // 3] = 0.0
    return x


@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("ties", (False, True))
def test_quantize_matches_pallas_and_numpy(bits, size, ties):
    x = _x(size, ties=ties)
    codes, scales = quantize_op(torch.from_numpy(x)[None], bits=bits)
    jc, js = jax_quantize_op(jnp.asarray(x), bits=bits)
    # XLA rewrites the Pallas kernel's absmax / qmax (a constant divisor) into
    # a multiply by the f32 reciprocal; the port keeps the true divide of the
    # numpy encoder, so against the interpret path the scales agree to 1 ulp,
    # and the codes agree wherever the scales do
    np.testing.assert_array_max_ulp(scales[0].numpy(), np.asarray(js), maxulp=1)
    same = scales[0].numpy() == np.asarray(js)
    np.testing.assert_array_equal(codes[0].numpy()[same], np.asarray(jc)[same])
    host = jax_make_codec(f"int{bits}")._encode_leaf(x)
    np.testing.assert_array_equal(codes[0].numpy(), host["codes"].reshape(codes[0].shape))
    np.testing.assert_array_equal(scales[0].numpy(), host["scales"])
    # decode: Pallas dequantize, the numpy decoder, and exact requantization
    out = dequantize_op(codes, scales, size=size, bits=bits)
    np.testing.assert_array_equal(
        out[0].numpy(), np.asarray(jax_dequantize_op(codes[0].numpy(), scales[0].numpy(),
                                                     size=size, bits=bits)))
    np.testing.assert_array_equal(out[0].numpy(),
                                  jax_make_codec(f"int{bits}")._decode_leaf(host))
    again = quantize_op(out, bits=bits)
    np.testing.assert_array_equal(again[0].numpy(), codes.numpy())


@pytest.mark.parametrize("bits", (8, 4))
def test_rows_are_encoded_on_their_own(bits):
    """A leading node axis encodes each row as if it were alone (padding
    per row, never over the concatenation)."""
    xs = np.stack([_x(1027, seed=s) for s in range(3)])
    xs[1] *= 100
    codes, scales = quantize_op(torch.from_numpy(xs), bits=bits)
    for i in range(3):
        c1, s1 = quantize_op(torch.from_numpy(xs[i])[None], bits=bits)
        np.testing.assert_array_equal(codes[i].numpy(), c1[0].numpy())
        np.testing.assert_array_equal(scales[i].numpy(), s1[0].numpy())
    vals, idx = topk_select_op(torch.from_numpy(xs), k=13)
    for i in range(3):
        v1, i1 = topk_select_op(torch.from_numpy(xs[i])[None], k=13)
        np.testing.assert_array_equal(vals[i].numpy(), v1[0].numpy())
        np.testing.assert_array_equal(idx[i].numpy(), i1[0].numpy())


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("ties", (False, True))
def test_topk_matches_ref_pallas_and_numpy(size, ties):
    codec = jax_make_codec("topk")
    x = _x(size, ties=ties)
    vals, idx = topk_select_op(torch.from_numpy(x)[None], k=codec.k, block=codec.block)
    blocks = jnp.asarray(codec._blocked(x))
    jv, ji = jax_topk_ref(blocks, codec.k)
    np.testing.assert_array_equal(vals[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ji))
    pv, pi = topk_select_blocks(blocks, k=codec.k, interpret=True)
    np.testing.assert_array_equal(vals[0].numpy(), np.asarray(pv))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(pi))
    host = codec._encode_leaf(x)
    np.testing.assert_array_equal(vals[0].numpy(), host["values"])
    np.testing.assert_array_equal(idx[0].numpy(), host["indices"])
    dense = topk_scatter(vals, idx, size=size, block=codec.block)
    np.testing.assert_array_equal(dense[0].numpy(), codec._decode_leaf(host))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("ties", (False, True))
def test_topk_threshold_model_matches_ref_and_pallas(size, ties):
    """The CUDA kernel's threshold decomposition, run in PyTorch, against
    ``lax.top_k`` and the Pallas kernel in interpret mode."""
    codec = jax_make_codec("topk")
    blocks = codec._blocked(_x(size, ties=ties))
    vals, idx = ref.topk_select_threshold(torch.from_numpy(np.asarray(blocks)), codec.k)
    jv, ji = jax_topk_ref(jnp.asarray(blocks), codec.k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    pv, pi = topk_select_blocks(jnp.asarray(blocks), k=codec.k, interpret=True)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(pv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))


@pytest.mark.parametrize("block", (32, 96, 256, 512, 1024))
@pytest.mark.parametrize("k", (1, 13, 33, "block"))
def test_topk_threshold_model_every_block_and_k(block, k):
    """Both ends of the search (the lane-max bracket for k <= 32, a search
    from 0 above), exact stops and ties at T, zero and infinite blocks."""
    k = min(block, 33) if k == 33 else block if k == "block" else k
    rng = np.random.default_rng(block + k)
    x = np.round(rng.normal(size=(12, block)) * 8).astype(np.float32) / 4
    x[:4] = rng.normal(size=(4, block)) * 3  # distinct magnitudes: exact stops
    x[4] = 0.0
    x[5, ::2] = -0.0
    x[6, :3] = [np.inf, -np.inf, np.inf]
    x[7] = -2.5
    vals, idx = ref.topk_select_threshold(torch.from_numpy(x), k)
    jv, ji = jax_topk_ref(jnp.asarray(x), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_topk_all_zero_block_selects_first_k():
    vals, idx = ref.topk_select_ref(torch.zeros(2, 256), 13)
    np.testing.assert_array_equal(idx.numpy(), np.tile(np.arange(13), (2, 1)))
    assert not vals.any()


@pytest.mark.parametrize("size", SIZES)
def test_bf16_matches_numpy_encoder(size):
    x = _x(size)
    (wire,) = make_codec("bf16").encode(torch.from_numpy(x)[None])
    bits = wire[0].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(bits, jax_make_codec("bf16")._encode_leaf(x)["bits"])
    back = make_codec("bf16").roundtrip(torch.from_numpy(x)[None])
    np.testing.assert_array_equal(back[0].numpy(),
                                  jax_make_codec("bf16")._decode_leaf(
                                      jax_make_codec("bf16")._encode_leaf(x)))


@pytest.mark.parametrize("name", ("fp32", "bf16", "int8", "int4", "topk"))
def test_wire_model_matches_jax(name):
    ours, theirs = make_codec(name), jax_make_codec(name)
    for n in (0, 1, 7, 255, 256, 1023, 1024, 1025, 5_300_000, 180_910_080):
        assert ours.wire_bytes(n) == theirs.wire_bytes(n)
    for m in (0.0, 1.0, 3.7, 1e4):
        assert ours.mean_atol(m) == theirs.mean_atol(m)
    assert ours.name == theirs.name and ours.lossless == theirs.lossless


@pytest.mark.parametrize("name", ("bf16", "int8", "int4", "topk"))
def test_per_send_wire_matches_jax(name):
    from repro.compress import per_send_wire_bytes as jb, per_send_wire_mb as jmb
    from repro_torch.compress import per_send_wire_bytes as tb, per_send_wire_mb as tmb

    for raw in (21.2e6, 14e6, 723.64032e6, 3.0):
        assert tb(make_codec(name), raw) == jb(jax_make_codec(name), raw)
    for mb, frac in ((21.2, 1.0), (14.0, 0.25), (723.64032, 1.0)):
        assert tmb(make_codec(name), mb, frac) == jmb(jax_make_codec(name), mb, frac)
    assert tmb(None, 21.2, 0.25) == jmb(None, 21.2, 0.25)


@pytest.mark.parametrize("name", ("int8", "int4", "topk", "bf16"))
def test_roundtrip_keeps_shape_and_dtype(name):
    x = torch.from_numpy(np.stack([_x(3050, seed=s) for s in range(2)]).reshape(2, 50, 61))
    out = make_codec(name).roundtrip(x)
    assert out.shape == x.shape and out.dtype == x.dtype
    bound = make_codec(name).mean_atol(float(x.abs().max()))
    if bound is not None:
        assert float((out - x).abs().max()) <= bound


def test_codec_ops_reject_other_devices():
    x = torch.zeros(1, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        quantize_op(x)


GROUP_SIZES = (0, 3, 384, 1000, 1027, 1536, 5000)  # ragged, tiny and empty leaves


def _group(rows, sizes, bits, seed=0):
    """Each leaf quantized on its own into the group's arenas; the leaves'
    inputs, the layout and the arenas."""
    layout = group_layout(rows, tuple(sizes), bits, 1024)
    codes, scales = layout.arenas(torch.device("cpu"))
    xs = [torch.from_numpy(np.stack([_x(s, seed=seed + 10 * r) * (r + 1) for r in range(rows)]))
          for s in sizes]
    for l, x in enumerate(xs):
        quantize_op(x, bits=bits, out=(layout.codes(codes, l), layout.scales(scales, l)))
    return xs, layout, codes, scales


@pytest.mark.parametrize("bits", (8, 4))
@pytest.mark.parametrize("rows", (1, 2, 3))
def test_dequantize_group_matches_pallas_and_rows(bits, rows):
    """One decode for the group: each leaf's rows equal the JAX dequantize_op
    (Pallas, interpret mode) of that row alone and dequantize_rows of the
    leaf, bit for bit."""
    xs, layout, codes, scales = _group(rows, GROUP_SIZES, bits)
    outs = dequantize_group_op(codes, scales, layout)
    assert [tuple(o.shape) for o in outs] == [(rows, s) for s in GROUP_SIZES]
    for l, (out, size) in enumerate(zip(outs, GROUP_SIZES)):
        c, s = layout.codes(codes, l), layout.scales(scales, l)
        assert torch.equal(out, ref.dequantize_rows(c, s, size, bits, 1024))
        for r in range(rows if size else 0):  # the Pallas grid needs a chunk
            want = jax_dequantize_op(c[r].numpy(), s[r].numpy(), size=size, bits=bits)
            np.testing.assert_array_equal(out[r].numpy(), np.asarray(want))
        # the round trip stays within the codec's bound of each row's input
        if size:
            bound = make_codec(f"int{bits}").mean_atol(float(xs[l].abs().max()))
            assert float((out - xs[l]).abs().max()) <= bound


@pytest.mark.parametrize("bits", (8, 4))
def test_quantize_into_an_arena_slice_matches_alone(bits):
    """quantize_op(out=...) writes a leaf's slices and nothing else of the
    arenas, with the codes and scales it gives alone."""
    sizes = (1027, 3, 5000)
    layout = group_layout(2, sizes, bits, 1024)
    codes, scales = layout.arenas(torch.device("cpu"))
    codes.fill_(99)
    scales.fill_(-1.0)
    x = torch.from_numpy(np.stack([_x(3, seed=5), _x(3, seed=6)]))
    got = quantize_op(x, bits=bits, out=(layout.codes(codes, 1), layout.scales(scales, 1)))
    want_c, want_s = quantize_op(x, bits=bits)
    assert torch.equal(layout.codes(codes, 1), want_c)
    assert torch.equal(layout.scales(scales, 1), want_s)
    assert got[0].data_ptr() == layout.codes(codes, 1).data_ptr()
    for l in (0, 2):  # the other leaves' slices are untouched
        assert bool((layout.codes(codes, l) == 99).all())
        assert bool((layout.scales(scales, l) == -1.0).all())


@pytest.mark.parametrize("bits", (8, 4))
def test_group_layout_is_leaf_major(bits):
    """Each leaf's codes, scales and output are one contiguous slice, in leaf
    order, the outputs on 16-byte boundaries; the device table holds
    (chunk0, out0, size, n_chunks) a leaf."""
    rows, sizes = 3, (5, 0, 1024, 1025, 7)
    layout = group_layout(rows, sizes, bits, 1024)
    assert layout is group_layout(rows, sizes, bits, 1024)  # cached by its key
    assert layout.n_chunks == (1, 0, 1, 2, 1)
    assert layout.chunk0 == [0, 3, 3, 6, 12, 15]
    assert layout.out0 == [0, 16, 16, 3088, 6164, 6188]
    assert layout.total_chunks == 15 and layout.n_out == 6188
    assert all(o % 4 == 0 for o in layout.out0)
    assert layout.key == (rows, sizes, bits)
    table = layout.table(torch.device("cpu"))
    assert table.dtype == torch.int64 and table.tolist() == [
        [0, 0, 5, 1], [3, 16, 0, 0], [3, 16, 1024, 1], [6, 3088, 1025, 2], [12, 6164, 7, 1]]
    assert layout.table(torch.device("cpu")) is table
    codes, scales = layout.arenas(torch.device("cpu"))
    assert codes.shape == (15, 1024 if bits == 8 else 512) and scales.shape == (15,)
    for l in range(len(sizes)):
        c, s = layout.codes(codes, l), layout.scales(scales, l)
        assert c.is_contiguous() and c.shape == (rows, layout.n_chunks[l], codes.shape[1])
        assert s.shape == (rows, layout.n_chunks[l])
    arena = torch.zeros(layout.n_out)
    outs = layout.outputs(arena)
    for o, (size, start) in zip(outs, zip(sizes, layout.out0)):
        assert o.shape == (rows, size) and o.is_contiguous()
        o.fill_(1.0)
    assert float(arena.sum()) == rows * sum(sizes)  # disjoint views


@pytest.mark.parametrize("name", ("int8", "int4", "topk", "bf16"))
def test_roundtrip_group_equals_roundtrip_a_leaf(name):
    """A group's round trip gives each leaf what roundtrip gives it alone:
    the same values, shape and dtype (a bf16 leaf beside f32 ones)."""
    codec = make_codec(name)
    ts = [torch.from_numpy(np.stack([_x(3050, seed=s) for s in range(2)]).reshape(2, 50, 61)),
          torch.from_numpy(np.stack([_x(1027, seed=s + 7) for s in range(2)])).bfloat16(),
          torch.from_numpy(np.stack([_x(3, seed=s + 9) for s in range(2)]))]
    got = codec.roundtrip_group(ts)
    for g, t in zip(got, ts):
        want = codec.roundtrip(t)
        assert g.shape == t.shape and g.dtype == t.dtype
        assert torch.equal(g, want)


def test_roundtrip_group_splits_past_the_kernels_table(monkeypatch):
    """More leaves than the decode kernel's table holds: one decode each
    MAX_GROUP_LEAVES leaves, each leaf as it is alone."""
    monkeypatch.setattr(codec_module, "MAX_GROUP_LEAVES", 2)
    calls = []
    real = codec_module.dequantize_group_op

    def counted(codes, scales, layout):
        calls.append(layout.sizes)
        return real(codes, scales, layout)

    monkeypatch.setattr(codec_module, "dequantize_group_op", counted)
    codec = make_codec("int8")
    ts = [torch.from_numpy(np.stack([_x(size, seed=r) for r in range(2)]))
          for size in (1027, 0, 384, 5000, 3)]
    got = codec.roundtrip_group(ts)
    assert calls == [(1027, 0), (384, 5000), (3,)]
    for g, t in zip(got, ts):
        assert torch.equal(g, codec.roundtrip(t))


@pytest.mark.parametrize("name", ["fp32", "bf16", "int8", "int4", "topk"])
def test_only_the_quantizers_decode_a_group_at_once(name):
    assert make_codec(name).grouped == (name in ("int8", "int4"))
