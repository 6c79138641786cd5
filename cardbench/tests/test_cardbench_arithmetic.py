"""The frozen cost and FLOP arithmetic against hand counts at the two cells'
shapes."""
import pytest

import spec

BF16, HBM = 989e12, 3.35e12
# a dense (attention) configuration's widths, for the formula's attention
# terms: granite-3-2b at 4 layers, 4 x (2, 2048)
DENSE = dict(hidden_size=2048, num_attention_heads=32, num_key_value_heads=8,
             intermediate_size=8192, num_hidden_layers=4, vocab_size=49155)
DENSE_TRAFFIC = dict(nodes=4, rows_per_node=2, seq_len=2048, codec="int8",
                     gossip_mode="dissemination")
FALCON = dict(hidden_size=4096, intermediate_size=8192, state_size=16, time_step_rank=256,
              num_hidden_layers=2, vocab_size=65024)
FALCON_TRAFFIC = dict(nodes=4, rows_per_node=1, seq_len=2048, codec="",
                      gossip_mode="tree_allreduce")
PAIRS = 2048 * 2049 // 2
# falcon-mamba's leaves a node: the embedding (65024 rows, a multiple of 128),
# the final norm, then over 2 layers the norm, the conv, dt_bias, D, the x
# and z projections, wdt_in, wB, wC, A_log, dt_proj and out_proj
FALCON_LEAVES = [65024 * 4096, 4096, 2 * 4096, 2 * 4 * 8192, 2 * 8192, 2 * 8192] \
    + [2 * 4096 * 8192] * 2 + [2 * 8192 * 256] + [2 * 8192 * 16] * 3 + [2 * 256 * 8192] \
    + [2 * 8192 * 4096]


def metric(name):
    return spec.load_module("metrics", name)


def test_scan_bound():
    fwd = (10 * 2048 * 8192 + 8 * 2048 * 16 + 4 * (8192 * 16 + 8192 + 8192 * 16)) / HBM
    bwd = (16 * 2048 * 8192 + 16 * 2048 * 16 + 8 * (8192 * 16 + 8192)) / HBM
    got = metric("scan_roofline_pct").step_bound_s(FALCON, FALCON_TRAFFIC)
    assert got == pytest.approx(8 * (fwd + bwd), rel=1e-12)


def test_codec_and_mix_bounds():
    p = sum(FALCON_LEAVES)
    assert p == 476_950_528
    chunks = sum(-(-x // 1024) for x in FALCON_LEAVES)
    wire = 1028 * chunks
    encode = 4 * (4 * p + wire) / HBM
    decode = 12 * (wire + 4 * p) / HBM
    got = metric("codec_roofline_pct").step_bound_s(FALCON_LEAVES, 4)
    assert got == pytest.approx(encode + decode, rel=1e-12)
    mix = metric("mix_roofline_pct").step_bound_s(FALCON_LEAVES, 4)
    assert mix == pytest.approx(4 * (16 * p + 4 * p) / HBM, rel=1e-12)


def test_model_flops():
    mfu = metric("step_mfu_pct")
    per_layer = 2048 * 2048 + 2 * 2048 * 512 + 2048 * 2048 + 3 * 2048 * 8192
    want = 6 * (4 * per_layer + 2048 * 49155) * 8 * 2048 + 12 * 64 * 32 * PAIRS * 8 * 4
    assert mfu.model_flops(DENSE, DENSE_TRAFFIC) == want
    assert want == pytest.approx(35.46e12, rel=1e-3)
    per_layer = 2 * 4096 * 8192 + 8192 * 256 + 2 * 8192 * 16 + 256 * 8192 + 8192 * 4096
    want = 6 * (2 * per_layer + 4096 * 65024) * 4 * 2048
    assert mfu.model_flops(FALCON, FALCON_TRAFFIC) == want
    assert want == pytest.approx(23.42e12, rel=1e-3)


def test_readers_read_their_context():
    ctx = {"steps": 10, "tokens_per_step": 16384, "window_s": 4.0, "peak_bytes": 2.5e10,
           "setup_s": 12.5, "step_ms": [float(i) for i in range(1, 21)],
           "phase_ms": {"fwd_bwd": [1.0, 3.0], "optimizer": [2.0], "gossip": [4.0, 6.0]},
           "profile": None}
    assert metric("train_tokens_per_s").read(ctx) == 40960.0
    assert metric("step_ms_p90").read(ctx) == 18.0  # nearest rank: the 18th of 20
    assert metric("peak_mem_gb").read(ctx) == 25.0
    assert metric("setup_s").read(ctx) == 12.5
    assert metric("fwd_bwd_ms").read(ctx) == 2.0
    assert metric("gossip_ms").read(ctx) == 5.0
    for name in ("device_idle_pct", "scan_roofline_pct", "codec_roofline_pct",
                 "mix_roofline_pct"):
        assert metric(name).read(dict(ctx, hyper=FALCON, traffic=DENSE_TRAFFIC)) is None
    rec = {"span_us": (0.0, 1e6), "device": [("k", 0.0, 3e5), ("k", 4e5, 9e5)], "host": []}
    # 0.8 s busy over 2 profiled steps against the window's 500 ms a step
    idle = metric("device_idle_pct").read(dict(ctx, profile=rec, profiled_steps=2,
                                                step_ms=[400.0, 600.0]))
    assert idle == pytest.approx(20.0)


def test_profile_reading():
    import profiled

    rec = {"span_us": (0.0, 100.0),
           "device": [("quantize_kernel<8>", 10.0, 30.0), ("mix_kernel<float>", 20.0, 40.0),
                      ("void scan_bwd_kernel", 60.0, 70.0), ("scan_kernel<16>", 85.0, 110.0)],
           "host": [("aten::mm", 40.0, 60.0), ("outer", 0.0, 100.0)]}
    assert profiled.busy_s(rec) == pytest.approx(55e-6)  # clipped to the span
    assert profiled.idle_gaps(rec)[0] == ["aten::mm", pytest.approx(20e-6)]
    codec = metric("codec_roofline_pct").PATTERN
    scan = metric("scan_roofline_pct").PATTERN
    assert profiled.kernel_s(rec, codec) == pytest.approx(20e-6)
    assert profiled.kernel_s(rec, scan) == pytest.approx(35e-6)
    assert profiled.kernel_s(rec, metric("mix_roofline_pct").PATTERN) == pytest.approx(20e-6)
    assert not metric("codec_roofline_pct").PATTERN.search("mix_kernel")
    assert metric("codec_roofline_pct").PATTERN.search("void dequantize_cta_kernel<8>(...)")
