"""The port's op counter (``repro_torch.launch.op_analysis``) and roofline.

The counter's FLOPs against analytic counts (a matmul, nine in a Python
loop: the counterparts of the HLO analyzer's trip-count tests in
``tests/test_substrates.py``), its bytes (operands plus outputs), its peak
of live bytes, and each kernel counted once, by its cost function, on the
CPU route and on fake tensors. Then the port's smoke prefill against the
JAX package's: its matmul FLOPs equal the dot FLOPs ``analyze_hlo`` counts
in the JAX forward compiled on the CPU, less the attention einsums, which
the port's flash op computes instead (stated analytically below). On a
mesh: one rank's FLOPs, bytes and collectives (a DTensor matmul counted at
its local shapes with its all-reduce; a config whose every product splits
over "model" counts the card's FLOPs over 16), and the 2x16x16 dry run of
every arch (prefill, decode and the meshed trainer's train_4k step) with its
collective term at the JAX roofline's wire weights.
"""
import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.launch import roofline as jax_roofline  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.model import Batch as JaxBatch  # noqa: E402
from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.kernels.attention.flash import flash_bwd_cost, flash_cost  # noqa: E402
from repro_torch.kernels.attention.ops import flash_attention_op  # noqa: E402
from repro_torch.kernels.codec.ops import quantize_op, topk_select_op  # noqa: E402
from repro_torch.kernels.codec.quant_pack import quantize_cost  # noqa: E402
from repro_torch.kernels.codec.topk_pack import topk_cost  # noqa: E402
from repro_torch.kernels.mixing.gossip_mix import mix_cost  # noqa: E402
from repro_torch.kernels.mixing.ops import gossip_mix_op  # noqa: E402
from repro_torch.kernels.scan.mamba_scan import scan_cost  # noqa: E402
from repro_torch.kernels.scan.ops import selective_scan_op  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.op_analysis import OpCounter  # noqa: E402
from repro_torch.models import Batch, build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def test_matmul_flops_exact():
    n = 256
    a = torch.randn(n, n)
    with OpCounter() as c:
        a @ a
    assert c.stats.flops == 2 * n ** 3


def test_python_loop_counts_every_iteration():
    n, trips = 128, 9
    a = torch.randn(n, n)
    out = a
    with OpCounter() as c:
        for _ in range(trips):
            out = out @ a
    assert c.stats.flops == trips * 2 * n ** 3
    assert c.stats.calls_by_op["mm"] == trips


def test_elementwise_add_counts_its_three_tensors_bytes():
    a, b = torch.randn(1000), torch.randn(1000)
    with OpCounter() as c:
        a + b
    assert c.stats.bytes == 3 * 1000 * 4
    assert c.stats.flops == 0


def test_indexed_reads_and_writes_count_the_elements_they_touch():
    """A gather or scatter moves its indices and the rows it touches (read
    and written), not the tensor it indexes: HLO's dynamic-slice and
    dynamic-update-slice rules."""
    table, idx, rows = torch.zeros(1000, 100), torch.tensor([1, 5]), torch.ones(2, 100)
    with OpCounter() as c:
        table[idx]
        table.index_put_((idx,), rows)
    assert c.stats.bytes_by_op["index"] == 2 * 8 + 2 * 2 * 100 * 4
    assert c.stats.bytes_by_op["index_put_"] == 2 * 8 + 2 * 2 * 100 * 4


def test_peak_counts_live_bytes_and_frees():
    a = torch.zeros(1000)
    with OpCounter(live=a) as c:
        b = a + 1  # 4000 more live
        del b  # freed
        d = torch.zeros(500)  # 2000 live on top of a
    assert c.stats.start_bytes == 4000
    assert c.stats.peak_bytes == 8000
    assert c.live_bytes == 6000
    del d


def _flash_inputs(grad=False):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 64, 4, 32), generator=g, requires_grad=grad)
    k = torch.randn((2, 64, 2, 32), generator=g, requires_grad=grad)
    v = torch.randn((2, 64, 2, 32), generator=g, requires_grad=grad)
    return q, k, v


def test_flash_call_counts_once_by_its_cost_on_the_cpu_route():
    q, k, v = _flash_inputs()
    with OpCounter() as c:
        flash_attention_op(q, k, v, causal=True)
    cost = flash_cost(q, k, True, 0, False)
    assert dict(c.stats.launches) == {"flash_attention": 1}
    assert (c.stats.flops, c.stats.bytes) == (cost.flops, cost.bytes)
    # 4 hd a visible pair a head: 64 * 65 / 2 causal pairs
    assert cost.flops == 4 * 32 * 2 * 4 * (64 * 65 // 2)


def test_flash_forward_and_backward_each_count_once():
    q, k, v = _flash_inputs(grad=True)
    with OpCounter() as c:
        out = flash_attention_op(q, k, v, causal=False)
        out.sum().backward()
    assert dict(c.stats.launches) == {"flash_attention": 1, "flash_attention_bwd": 1}
    fwd, bwd = flash_cost(q, k, False, 0, True), flash_bwd_cost(q, k, False, 0)
    assert c.stats.flops_by_op["flash_attention"] == fwd.flops
    assert c.stats.flops_by_op["flash_attention_bwd"] == bwd.flops
    assert c.stats.flops == fwd.flops + bwd.flops  # the sum and ones_like do none


def test_scan_call_counts_once_by_its_cost():
    g = torch.Generator().manual_seed(1)
    b, s, di, n = 1, 80, 16, 4
    dt = torch.rand((b, s, di), generator=g)
    Bm, Cm = torch.randn((b, s, n), generator=g), torch.randn((b, s, n), generator=g)
    x = torch.randn((b, s, di), generator=g)
    A_log, D = torch.zeros((di, n)), torch.ones(di)
    with OpCounter() as c:
        selective_scan_op(dt, Bm, Cm, x, A_log, D)
    cost = scan_cost(dt, Bm, x, None, False)
    assert dict(c.stats.launches) == {"selective_scan": 1}
    assert (c.stats.flops, c.stats.bytes) == (cost.flops, cost.bytes)


def test_codec_and_mix_calls_count_once_by_their_costs():
    x = torch.randn((3, 5000))
    with OpCounter() as c:
        quantize_op(x, bits=8)
        topk_select_op(x, k=13, block=256)
        gossip_mix_op(x.reshape(1, 3, 5000), torch.full((3,), 1 / 3))
    assert dict(c.stats.launches) == {"quantize": 1, "topk_select": 1, "gossip_mix": 1}
    want = (quantize_cost(3, 5000, 8, 1024), topk_cost(3, 5000, 256, 13),
            mix_cost(x.reshape(1, 3, 5000)))
    assert c.stats.flops == sum(w.flops for w in want)
    assert c.stats.flops_by_op["quantize"] == 5 * 3 * 5000


def test_fake_route_counts_as_the_cpu_route():
    """A fake tensor takes the kernels' fake route (no launch, no plain
    version) and counts exactly what the CPU route counts."""
    q, k, v = _flash_inputs()
    with OpCounter() as cpu:
        flash_attention_op(q, k, v, causal=True)
    with FakeTensorMode():
        fq, fk, fv = (torch.empty(t.shape) for t in (q, k, v))
        with OpCounter() as fake:
            out = flash_attention_op(fq, fk, fv, causal=True)
        assert out.shape == q.shape and out.dtype == q.dtype
    assert (fake.stats.flops, fake.stats.bytes) == (cpu.stats.flops, cpu.stats.bytes)
    assert fake.stats.launches == cpu.stats.launches


def test_model_flops_for_matches_jax():
    for name in pt_configs.list_archs():
        cfg_t, cfg_j = pt_configs.get_arch(name), jax_configs.get_arch(name)
        for shape in pt_configs.INPUT_SHAPES.values():
            got = roofline.model_flops_for(cfg_t, shape, shape.kind)
            want = jax_roofline.model_flops_for(cfg_j, jax_configs.INPUT_SHAPES[shape.name],
                                                shape.kind)
            assert got == want, (name, shape.name)


def test_roofline_terms_at_h100_constants():
    r = roofline.Roofline("a", "s", "1xH100", 1, 989e12, 3.35e12 / 2, 450e9 * 3, 1.0,
                          989e12 / 2)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 0.5, 3.0)
    assert r.bottleneck == "compute" and r.bound_s == 1.0
    assert r.useful_flops_ratio == 0.5
    assert r.mfu(2.0) == 0.25 and r.roofline_share(2.0) == 0.5


def test_no_tpu_constants_in_the_port():
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        for const in ("197e12", "819e9", "50e9"):  # v5e's (repro/launch/roofline.py)
            assert not re.search(rf"(?<![\d.]){const}", text), \
                f"{path.relative_to(ROOT)} holds {const}"


# -- the port's smoke prefill against the JAX forward's HLO --------------------------

def _dot_flops_of_jax_forward(mj, params_j, batch_j):
    """The dot (and convolution) FLOPs analyze_hlo counts in the compiled
    forward, trip counts included: its elementwise count set to nothing."""
    compiled = jax.jit(lambda p, b: mj.forward(p, b)[0]).lower(params_j, batch_j).compile()
    saved = hlo_analysis._ELEMWISE
    hlo_analysis._ELEMWISE = set()
    try:
        return hlo_analysis.analyze_hlo(compiled.as_text()).flops
    finally:
        hlo_analysis._ELEMWISE = saved


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen3-moe-30b-a3b"])
def test_smoke_prefill_matmul_flops_match_the_jax_hlo_dots(arch):
    """The port's mm / bmm FLOPs of a smoke prefill equal the JAX forward's
    dot FLOPs less its attention einsums: each layer's scores and P V over
    every (query, key) pair of the expanded heads, 2 b H s s_kv hd each
    (the JAX package's masked einsum computes the masked pairs too). No
    tolerance: both counts are exact integers."""
    cfg_j = jax_configs.get_arch(arch).smoke_variant()
    cfg_t = pt_configs.get_arch(arch).smoke_variant()
    b, s = 2, 64
    mj, mt = jax_build_model(cfg_j), build_model(cfg_t, device="cpu")
    params_j = mj.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, cfg_t.vocab, (b, s)).astype(np.int32)
    dots = _dot_flops_of_jax_forward(mj, params_j, JaxBatch(tokens=jnp.asarray(tokens)))
    attention = cfg_t.n_layers * 2 * (2 * b * cfg_t.eff_n_heads * s * s * cfg_t.resolved_head_dim)
    with torch.inference_mode(), OpCounter() as c:
        mt.forward(from_numpy(params_j, device="cpu"), Batch(tokens=torch.from_numpy(tokens).long()))
    matmul = sum(c.stats.flops_by_op[op] for op in ("mm", "bmm", "addmm", "baddbmm"))
    assert dict(c.stats.launches) == {"flash_attention": cfg_t.n_layers}
    assert matmul == dots - attention


# -- one rank of a mesh ----------------------------------------------------------------
# In subprocesses (a process group is global to its process): the dry run
# at 2x16x16 for every arch at 2 layers, half the archs a process; a config
# whose every product splits over "model" at batch 1 (no batch split), meshed
# and on one card; and a DTensor matmul under the counter.
_MESH_RUN = """
import json, sys
import torch
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import OpCounter
out = {}
if sys.argv[1] == "split":
    # 16 heads and kv heads, d_ff 512, vocab 512: every product splits over 16
    over = dict(n_heads=16, n_kv_heads=16, head_dim=32)
    for shape in ("prefill_32k", "decode_32k"):
        for mesh in ("16x16", "1xH100"):
            r = dryrun.dryrun_pair("smollm-360m", shape, mesh=mesh, smoke=True, batch=1, seq=64,
                                   arch_overrides=over, verbose=False)
            out[mesh + "/" + shape] = r
    # a row-parallel matmul: x (8, 16) rows on data, w (16, 8) rows on model
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dryrun.fake_group(4)
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    x = DTensor.from_local(torch.ones(4, 8), mesh, [Shard(0), Shard(1)], run_check=False)
    w = DTensor.from_local(torch.ones(8, 8), mesh, [Replicate(), Shard(0)], run_check=False)
    with torch.no_grad(), OpCounter(live=(x, w)) as c:
        y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
    out["matmul"] = dict(flops=c.stats.flops, collectives=dict(c.stats.collectives),
                         collective_bytes=dict(c.stats.collective_bytes),
                         start=c.stats.start_bytes, local=list(y.to_local().shape))
    # DTensor's all-to-all on fake tensors (the card's path; a CPU mesh
    # gathers instead): its fake output is a slice of a 2x larger buffer
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed import _functional_collectives as funcol
    name = funcol._group_or_group_name(funcol._resolve_group((mesh, 1)))
    with FakeTensorMode():
        x = torch.empty(8, 6)
        with OpCounter(live=(x,)) as c:
            y = torch.ops._dtensor.shard_dim_alltoall(x, 0, 1, name)
    out["alltoall"] = dict(start=c.stats.start_bytes, peak=c.stats.peak_bytes,
                           collectives=dict(c.stats.collectives), shape=list(y.shape))
else:
    for arch in sys.argv[2].split(","):
        kw = dict(layers=2, arch_overrides={"attn_every": 2} if arch == "zamba2-7b" else None)
        for shape in ("prefill_32k", "decode_32k", "train_4k"):
            r = dryrun.dryrun_pair(arch, shape, mesh="2x16x16", verbose=False, **kw)
            out[arch + "/" + shape] = r
print("RESULT " + json.dumps(out, default=str))
"""
MESH_ARCHS = pt_configs.list_archs()


@pytest.fixture(scope="module")
def meshed():
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH="src")
    half = len(MESH_ARCHS) // 2
    jobs = [("multi", MESH_ARCHS[:half]), ("multi", MESH_ARCHS[half:]), ("split", [])]
    procs = [subprocess.Popen([sys.executable, "-c", _MESH_RUN, kind, ",".join(archs)],
                              cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for kind, archs in jobs]
    out = {}
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
        assert p.returncode == 0 and lines, stderr[-3000:]
        out.update(json.loads(lines[-1][7:]))
    return out


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_meshed_dry_run_2x16x16(meshed, arch, shape):
    r = meshed[f"{arch}/{shape}"]
    assert r["status"] == "ok", r.get("error")
    assert r["mesh"] == "2x16x16" and r["n_chips"] == 512
    assert r["flops_per_device"] > 0 and r["peak_memory_bytes"] > 0
    # the collective term: the counted collectives' bytes at the JAX wire weights
    assert roofline.WIRE_WEIGHT == jax_roofline._WIRE_WEIGHT
    want = sum(b * jax_roofline._WIRE_WEIGHT[k] for k, b in r["collective_bytes_by_kind"].items())
    assert r["collective_bytes_per_device"] == want > 0
    assert set(r["collective_counts"]) == set(r["collective_bytes_by_kind"])
    assert r["collective_s"] == want / roofline.LINK_BW


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_rank_flops_are_the_card_s_over_the_model_width(meshed, shape):
    """Batch 1 does not split, so the prefill's products (projections, MLP,
    readout, flash) split over "model" alone: the card's FLOPs over 16. The
    decode step's matmuls do too; its attention einsums (bmm) split also
    over "data", which holds the cache's sequence when the batch cannot
    (the long_500k rule): over 256."""
    one, rank = meshed[f"1xH100/{shape}"], meshed[f"16x16/{shape}"]
    assert one["status"] == rank["status"] == "ok", (one.get("error"), rank.get("error"))
    assert rank["batch_axes"] == []
    split = {op: 256 if op == "bmm" else 16 for op in one["top_flops"]}
    assert {k: v * split[k] for k, v in rank["top_flops"].items()} == one["top_flops"]
    if shape == "prefill_32k":
        assert rank["flops_per_device"] * 16 == one["flops_per_device"]
        assert rank["kernel_launches"] == one["kernel_launches"] == {"flash_attention": 2}


def test_counter_counts_a_rank_s_local_ops_and_collectives(meshed):
    r = meshed["matmul"]
    # the local (4, 8) @ (8, 8) product alone (not DTensor's (8, 16) @ (16, 8)
    # shape propagation), and one all-reduce of the (4, 8) f32 partial sums
    assert r["flops"] == 2 * 4 * 8 * 8
    assert r["collectives"] == {"all-reduce": 1}
    assert r["collective_bytes"] == {"all-reduce": 4 * 8 * 4}
    assert r["start"] == (4 * 8 + 8 * 8) * 4 and r["local"] == [4, 8]
    # an all-to-all's output counts its own bytes, as the card allocates it,
    # and its peak the copy of the input it holds beside the output
    r = meshed["alltoall"]
    assert r["collectives"] == {"all-to-all": 1} and r["shape"] == [16, 3]
    assert r["peak"] == r["start"] + 16 * 3 * 4 + 8 * 6 * 4
