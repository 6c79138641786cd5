"""The port's one-card dry run (``repro_torch.launch.dryrun``) and the config
counts it rests on.

* ``active_param_count``, ``param_count`` and ``input_specs`` equal the JAX
  package's for every arch and every ``INPUT_SHAPES`` entry, exactly.
* For the smoke variant of every family, ``dryrun_pair`` traces one DFL
  train step on fake tensors (``status == "ok"``) and its FLOPs and kernel
  launches equal the op counter's on a real CPU step of the same config,
  exactly; the trace reaches no kernel library and no plain version.
* Prefill and decode trace for every family; ``long_500k`` is skipped for
  whisper-tiny, as the reference's dry run skips it. A decode step's peak
  holds one new cache beside the old one (P13).
* The dry run's CUDA device: ``resolve_device`` gives it only while the dry
  run's fake mode is active.
* Total bytes (``bytes_per_device``) of the dry steps equal the real CPU
  steps' (P7: the attention plain versions return the kernels' contiguous
  layout, so no copy appears on the CPU alone). The Mamba mixers traced on
  fake tensors under ``no_grad`` count the bytes of the same mixers on real
  ones, with one ``softplus`` each; on the card's PyTorch fake CUDA tensors
  hand ``softplus`` to the counter decomposed, and ``kernels.whole_op``
  counts it once either way (a decomposition's parts under it are held
  here). This CPU-only build makes fake CUDA tensors but cannot index them,
  so the mixers trace on fake CPU tensors; phases 7 and 8 of
  ``chip_smoke.py`` hold the card's bytes.
* ``--mesh 16x16``: every arch at 2 layers traces rank 0's prefill and
  decode (``ok``, with its FLOPs, bytes, collectives and ``fits_hbm``), and
  its peak and FLOPs are below the one-card dry run's at the same cut; the
  training step (the meshed trainer) is ``ok`` with a ``gossip`` block whose
  node count is the JAX config's node axes on the mesh, and a pair that does
  not fit says why. smollm-360m (16 / 32 nodes) and qwen3-moe-30b-a3b (1 / 2:
  its node axes are "pod") at ``16x16`` and ``2x16x16``: the rank's
  point-to-point bytes (kind ``collective-permute``) equal its share of the
  plan (``rank_gossip_bytes``), and the shares of every node sum to
  ``gossip_collective_bytes``. ``2x16x16`` prefill and
  decode are held in ``tests/test_torch_op_analysis.py``. Files end
  ``__multipod.json`` / ``__singlepod.json``, as the JAX dry run's.
* P8: qwen3-moe-30b-a3b's 16x16 prefill traced on the CPU (a ``cpu`` mesh
  under the fake group) moves its experts by all-to-alls as the card does,
  and its rank peak is within ``PEAK_TOL`` of the card's trace.

Time limit: the meshed traces run in three subprocesses at once, each cut at
600 s (``_run_meshes``); the whole file took 275 s with 4 workers on a loaded
8-core host.
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch.dfl.trainer import DFLConfig, DFLTrainer  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import ops as attention_ops  # noqa: E402
from repro_torch.kernels.codec import ref as codec_ref  # noqa: E402
from repro_torch.kernels.mixing import ops as mixing_ops  # noqa: E402
from repro_torch.kernels.scan import ops as scan_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.op_analysis import OpCounter  # noqa: E402
from repro_torch.models import Batch, build_model  # noqa: E402

FAMILIES = {"dense": "smollm-360m", "ssm": "falcon-mamba-7b", "moe": "qwen3-moe-30b-a3b",
            "hybrid": "zamba2-7b", "audio": "whisper-tiny", "vlm": "paligemma-3b"}
NODES, BATCH, SEQ = 4, 8, 32
ROOT = Path(__file__).resolve().parents[1]
DTYPES = {jnp.int32: torch.int32, jnp.int64: torch.int64, jnp.bfloat16: torch.bfloat16,
          jnp.float32: torch.float32}


@pytest.mark.parametrize("arch", pt_configs.list_archs())
def test_param_counts_match_jax(arch):
    cfg_t, cfg_j = pt_configs.get_arch(arch), jax_configs.get_arch(arch)
    assert cfg_t.param_count() == cfg_j.param_count()
    assert cfg_t.active_param_count() == cfg_j.active_param_count()
    smoke_t, smoke_j = cfg_t.smoke_variant(), cfg_j.smoke_variant()
    assert smoke_t.active_param_count() == smoke_j.active_param_count()


@pytest.mark.parametrize("arch", pt_configs.list_archs())
def test_input_specs_match_jax(arch):
    cfg_t, cfg_j = pt_configs.get_arch(arch), jax_configs.get_arch(arch)
    for name, shape in pt_configs.INPUT_SHAPES.items():
        got = pt_configs.input_specs(cfg_t, shape)
        want = jax_configs.input_specs(cfg_j, jax_configs.INPUT_SHAPES[name])
        assert list(got) == list(want), (arch, name)
        for key, (dims, dtype) in got.items():
            assert dims == tuple(want[key].shape), (arch, name, key)
            assert dtype == DTYPES[want[key].dtype.type], (arch, name, key)


def _cpu_step(cfg, dfl=None):
    """The op counter's stats of one steady real DFL step on the CPU (after
    one step), with the dry run's inputs (zero token ids, zero frontends in
    f32, as the launcher feeds them)."""
    model = build_model(cfg, device="cpu")
    trainer = DFLTrainer(model, NODES, dfl or DFLConfig(), device="cpu")
    state = trainer.state_from_params(model.init(torch.Generator().manual_seed(0)))
    shape = pt_configs.InputShape("train_4k", SEQ, BATCH, "train")
    batch = Batch(**{k: torch.zeros(dims, dtype=torch.int64 if k in ("tokens", "labels")
                                    else torch.float32)
                     for k, (dims, dtype) in pt_configs.input_specs(cfg, shape).items()})
    state, _ = trainer.train_step(state, batch)
    with OpCounter(live=(state, batch)) as counter:
        trainer.train_step(state, batch)
    return counter.stats


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dry_train_step_counts_as_a_cpu_step(family, monkeypatch):
    arch = FAMILIES[family]

    def no_call(*_, **__):
        raise AssertionError("the dry run reached a kernel library or a plain version")

    with monkeypatch.context() as m:
        m.setattr(_build, "lib", no_call)
        for mod, names in ((attention_ops, ("attention_ref", "attention_lse_ref",
                                            "attention_bwd_ref")),
                           (scan_ops, ("selective_scan_ref", "selective_scan_bwd_ref")),
                           (mixing_ops, ("gossip_mix_ref",)),
                           (codec_ref, ("quantize_rows", "dequantize_rows",
                                        "dequantize_group", "topk_select_rows"))):
            for name in names:
                m.setattr(mod, name, no_call)
        res = dryrun.dryrun_pair(arch, "train_4k", nodes=NODES, batch=BATCH, seq=SEQ,
                                 smoke=True, verbose=False)
    assert res["status"] == "ok", res.get("traceback")
    stats = _cpu_step(pt_configs.get_arch(arch).smoke_variant())
    assert res["flops_per_device"] == stats.flops
    assert res["bytes_per_device"] == stats.bytes
    assert res["kernel_launches"] == dict(stats.launches)
    assert res["start_memory_bytes"] == stats.start_bytes  # the steady state's tensors
    assert res["kernel_launches"]  # every family's step runs a kernel
    assert res["gossip"]["n_nodes"] == NODES and res["fits_hbm"] is True
    json.dumps(res)


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_dry_codec_step_counts_as_a_cpu_step(codec):
    """A dissemination step with a codec: every gossip kernel once a launch
    (the grouped dequantize, top-k's error feedback) on both routes."""
    res = dryrun.dryrun_pair("smollm-360m", "train_4k", nodes=NODES, batch=BATCH, seq=SEQ,
                             gossip_mode="dissemination", dfl_overrides={"codec": codec},
                             smoke=True, verbose=False)
    assert res["status"] == "ok", res.get("traceback")
    stats = _cpu_step(pt_configs.get_arch("smollm-360m").smoke_variant(),
                      DFLConfig(gossip_mode="dissemination", codec=codec))
    assert res["flops_per_device"] == stats.flops
    assert res["bytes_per_device"] == stats.bytes
    assert res["kernel_launches"] == dict(stats.launches)
    assert res["start_memory_bytes"] == stats.start_bytes
    assert res["kernel_launches"]["gossip_mix"] > 0
    assert res["collective_bytes_per_device"] < res["gossip"]["analytic_bytes"][
        "dissemination"] / NODES  # the codec's wire, a node's share


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dry_prefill_and_decode_trace(family):
    arch = FAMILIES[family]
    for shape in ("prefill_32k", "decode_32k"):
        res = dryrun.dryrun_pair(arch, shape, batch=2, seq=64, smoke=True, verbose=False)
        assert res["status"] == "ok", res.get("traceback")
        assert res["flops_per_device"] > 0 and res["peak_memory_bytes"] > 0
        assert res["model_flops"] > 0 and "gossip" not in res


def test_decode_step_holds_one_new_cache_beside_the_old():
    """P13: a decode step writes its new cache into one stacked tree a layer
    at a time, so beside the old cache its peak holds one new cache and a
    layer's work. Stacking the per-layer copies held two new caches: 2.0 x
    the cache over the start here, and gemma2-2b's long_500k step at full
    depth (a 27.9 GB cache) traced to 89.6 GB, more than the card holds.
    gemma2's smoke variant at 16 layers over a 65536-token cache: 8 global
    layers' caches of 65536 and 8 local rings of 128, f32."""
    res = dryrun.dryrun_pair("gemma2-2b", "long_500k", smoke=True, layers=16, seq=65536,
                             verbose=False)
    assert res["status"] == "ok", res.get("traceback")
    cache = 2 * (8 * 65536 + 8 * 128) * 4 * 64 * 4  # k and v, 4 kv heads of 64, f32
    assert res["start_memory_bytes"] > cache
    assert cache < res["peak_memory_bytes"] - res["start_memory_bytes"] < 1.5 * cache


def test_long_500k_skipped_for_whisper():
    res = dryrun.dryrun_pair("whisper-tiny", "long_500k", verbose=False)
    assert res["status"] == "skipped"


def test_resolve_device_gives_cuda_only_inside_the_fake_mode():
    if torch.cuda.is_available():
        pytest.skip("a card is present: resolve_device gives CUDA anyway")
    with pytest.raises(RuntimeError, match="none is available"):
        repro_torch.resolve_device("cuda")
    with FakeTensorMode():
        assert repro_torch.resolve_device("cuda").type == "cuda"
    with pytest.raises(RuntimeError, match="none is available"):
        repro_torch.resolve_device(None)


def test_cli_writes_one_json_a_pair(tmp_path):
    rc = dryrun.main(["--arch", "whisper-tiny", "--shape", "prefill_32k", "--smoke",
                      "--batch", "2", "--seq", "32", "--out", str(tmp_path)])
    assert rc == 0
    (path,) = tmp_path.glob("*.json")
    assert path.name == "whisper-tiny__prefill_32k__1xH100.json"
    assert json.loads(path.read_text())["status"] == "ok"


# -- rank 0 of the production layouts (``--mesh``) ---------------------------------------
# Each mesh runs in a subprocess: a process group (here the dry run's fake
# one) is global to its process. Every arch at 2 layers (zamba2-7b with
# attn_every 2: one super-block; gemma2-2b needs an even count), prefill_32k
# and decode_32k at their global batches, and train_4k (not ported); the
# one-card dry run of the same cut beside them.
MESH_ARCHS = pt_configs.list_archs()
MESH_SHAPES = ("prefill_32k", "decode_32k", "train_4k")
_MESH_RUN = """
import json, sys
from repro_torch.launch import dryrun
mesh, archs = sys.argv[1], sys.argv[2].split(",")
out = {}
for arch in archs:
    kw = dict(layers=2, arch_overrides={"attn_every": 2} if arch == "zamba2-7b" else None)
    for shape in ("prefill_32k", "decode_32k", "train_4k"):
        if mesh == "1xH100" and shape == "train_4k":
            continue
        r = dryrun.dryrun_pair(arch, shape, mesh=mesh, verbose=False, **kw)
        r.pop("traceback", None) if r["status"] == "ok" else None
        out[arch + "/" + shape] = r
print("RESULT " + json.dumps(out, default=str))
"""


def _run_meshes(jobs):
    """{(mesh, arch/shape): result} of ``_MESH_RUN`` over ``jobs`` (mesh,
    archs), each a subprocess, all at once."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, PYTHONPATH="src")
    procs = [(mesh, subprocess.Popen([sys.executable, "-c", _MESH_RUN, mesh, ",".join(archs)],
                                     cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))
             for mesh, archs in jobs]
    out = {}
    for mesh, p in procs:
        stdout, stderr = p.communicate(timeout=600)
        lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
        assert p.returncode == 0 and lines, stderr[-3000:]
        out.update({(mesh, k): v for k, v in json.loads(lines[-1][7:]).items()})
    return out


GOSSIP_ARCHS = ("smollm-360m", "qwen3-moe-30b-a3b")
MESH_SIZES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(scope="module")
def meshed():
    return _run_meshes([("16x16", MESH_ARCHS), ("1xH100", MESH_ARCHS),
                        ("2x16x16", GOSSIP_ARCHS)])


def _jax_nodes(arch, mesh):
    """The JAX package's DFL node count of ``arch`` on a production layout:
    the product of its node axes that the mesh has."""
    sizes = MESH_SIZES[mesh]
    n = 1
    for a in jax_configs.get_arch(arch).node_axes:
        n *= sizes.get(a, 1)
    return n


@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_meshed_dry_run_16x16(meshed, arch, shape):
    r = meshed[("16x16", f"{arch}/{shape}")]
    if shape == "train_4k":
        assert r["status"] == "ok", r.get("error")
        assert r["gossip"]["n_nodes"] == _jax_nodes(arch, "16x16"), r["gossip"]
        assert r["flops_per_device"] > 0 and r["kernel_launches"], r
        assert isinstance(r["fits_hbm"], bool)
        if not r["fits_hbm"]:
            assert "over the card" in r["reason"], r
        assert (r["collective_bytes_by_kind"].get("collective-permute", 0.0)
                == r["gossip"]["rank_p2p_bytes"])
        return
    assert r["status"] == "ok", r.get("error")
    assert r["mesh"] == "16x16" and r["n_chips"] == 256
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert isinstance(r["fits_hbm"], bool)
    one = meshed[("1xH100", f"{arch}/{shape}")]
    assert one["status"] == "ok", one.get("error")
    assert r["peak_memory_bytes"] < one["peak_memory_bytes"], (r["peak_memory_gb"],
                                                              one["peak_memory_gb"])
    assert r["flops_per_device"] < one["flops_per_device"]
    assert sum(r["collective_counts"].values()) > 0
    assert r["collective_bytes_per_device"] > 0 and r["collective_s"] > 0


def test_meshed_files_are_named_as_the_jax_dry_runs(tmp_path):
    rc = dryrun.main(["--arch", "whisper-tiny", "--shape", "train_4k", "--multi-pod",
                      "--out", str(tmp_path)])
    assert rc == 0
    (path,) = tmp_path.glob("*.json")
    assert path.name == "whisper-tiny__train_4k__multipod.json"
    res = json.loads(path.read_text())
    assert res["status"] == "ok" and res["mesh"] == "2x16x16" and res["n_chips"] == 512
    assert res["gossip"]["n_nodes"] == _jax_nodes("whisper-tiny", "2x16x16") == 32


def _local_masters(arch, mesh):
    """Rank 0's f32 master shards of ``arch`` at 2 layers on a layout, as
    meta tensors (the tree gossip sends f32 partial sums)."""
    from repro_torch.dfl.sharding import local_shape, map_specs, param_shapes, param_spec_tree

    cfg = pt_configs.get_arch(arch).replace(n_layers=2)
    shapes = param_shapes(build_model(cfg, "train_4k", device="cpu"))

    class Duck:
        shape = MESH_SIZES[mesh]

    specs = param_spec_tree(cfg, shapes, Duck())
    return map_specs(lambda sp, t: torch.empty(local_shape(Duck(), sp, t.shape),
                                               dtype=torch.float32, device="meta"),
                     specs, shapes)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", GOSSIP_ARCHS)
def test_meshed_train_gossip_is_the_ranks_share(meshed, arch, mesh):
    from repro_torch.dfl.collectives import (GossipPlan, gossip_collective_bytes,
                                             rank_gossip_bytes, tree_flatten)

    r = meshed[(mesh, f"{arch}/train_4k")]
    assert r["status"] == "ok", r.get("error")
    g = r["gossip"]
    n = _jax_nodes(arch, mesh)
    assert g["n_nodes"] == n and g["mode"] == "tree_allreduce", g
    assert set(g["analytic_bytes"]) == set(dryrun.GOSSIP_MODES)
    p2p = r["collective_bytes_by_kind"].get("collective-permute", 0.0)
    assert p2p == g["rank_p2p_bytes"]
    if n == 1:
        assert p2p == 0.0 and "collective-permute" not in r["collective_counts"]
        return
    # the plan of the same nodes (pods priced apart on 2x16x16): rank 0's share,
    # and every node's shares summing to the round's analytic bytes
    plan = GossipPlan.build(n, n_pods=MESH_SIZES[mesh].get("pod", 1) if n > 16 else 1)
    local = _local_masters(arch, mesh)
    assert p2p == rank_gossip_bytes("tree_allreduce", plan, local, node=0) > 0
    total = sum(rank_gossip_bytes("tree_allreduce", plan, local, node=i) for i in range(n))
    shard = sum(t.numel() * 4 for t in tree_flatten(local)[0])
    # (the analytic formula rounds through MB)
    assert total == pytest.approx(gossip_collective_bytes("tree_allreduce", plan, shard),
                                  rel=1e-12)
    assert g["tree_slots"] == plan.tree.n_slots and g["mst_slots"] == plan.dissemination.n_slots


def test_mamba_mixers_count_softplus_once():
    """P7: the Mamba1 and Mamba2 mixers under ``no_grad`` on fake tensors and
    on real ones count the same bytes and one ``softplus`` each; and
    ``whole_op`` counts an op once, at its input and output, when its parts
    reach the counter decomposed (as the card's fake CUDA tensors hand
    ``softplus`` over; this CPU-only build makes fake CUDA tensors but cannot
    index them, so the mixers trace on fake CPU tensors here)."""
    from repro_torch.kernels import whole_op
    from repro_torch.models import mamba

    cfg = pt_configs.get_arch("falcon-mamba-7b").smoke_variant()
    cfg2 = pt_configs.get_arch("zamba2-7b").smoke_variant()

    def run():
        g = torch.Generator().manual_seed(0)
        p1 = mamba.init_mamba1(g, cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                               cfg.conv_width, torch.float32)
        p2 = mamba.init_mamba2(g, cfg2.d_model, cfg2.d_inner, cfg2.ssm_state, cfg2.conv_width,
                               torch.float32)
        x1, x2 = torch.zeros((2, 64, cfg.d_model)), torch.zeros((2, 64, cfg2.d_model))
        with torch.no_grad(), OpCounter() as counter:
            mamba.mamba1_forward(p1, x1, cfg.ssm_state, cfg.dt_rank)
            mamba.mamba2_forward(p2, x2, cfg2.ssm_state)
        return counter.stats

    real = run()
    with FakeTensorMode():
        fake = run()
    assert fake.bytes == real.bytes and fake.flops == real.flops
    assert fake.calls_by_op["softplus"] == real.calls_by_op["softplus"] == 2

    x = torch.randn(4, 8)
    with OpCounter() as counter:
        with whole_op("softplus", x):  # the parts a decomposition dispatches
            y = torch.where(x > 20.0, x, torch.log1p(torch.exp(x)))
    assert torch.allclose(y, torch.nn.functional.softplus(x))
    st = counter.stats
    assert dict(st.calls_by_op) == {"softplus": 1} and st.bytes == 2 * x.numel() * 4


def test_meshed_train_gathers_whole_vocab_logits_p9(meshed):
    """ROADMAP P9 (fixed): the meshed training step keeps its f32 logits
    split by vocabulary into the vocab-parallel cross-entropy
    (``models/layers.py::_VocabParallelCE``), as the JAX model does: no
    all-gather of (rows, seq, padded vocab) f32 (12.9 GB for smollm-360m's
    16x16 train_4k step, 16 rows of 4096 a rank, before the fix); every
    all-gather of the step is a sequence gather of the (rows, seq, d) bf16
    hidden state, and the step fits the card at 2 layers."""
    from repro_torch.models.layers import padded_vocab

    r = meshed[("16x16", "smollm-360m/train_4k")]
    cfg = pt_configs.get_arch("smollm-360m")
    rows, seq = 256 // 16, 4096
    whole_vocab = rows * seq * padded_vocab(cfg.vocab) * 4
    hidden = rows * seq * cfg.d_model * 2
    gathers = r["collective_counts"]["all-gather"]
    assert r["collective_bytes_by_kind"]["all-gather"] == gathers * hidden < whole_vocab
    assert r["fits_hbm"] is True


def test_meshed_train_has_no_sequence_split_p10(meshed):
    """ROADMAP P10 (fixed): the meshed trainer runs the layers with
    Megatron's sequence split, as the prefill does: each row-parallel output
    is reduce-scattered along the sequence (``models/layers.py::_SeqScatter``)
    and the hidden state all-gathered ahead of the projections
    (``_SeqGather``, a reduce-scatter in the backward), where the step
    before the fix all-reduced every row-parallel output. The one
    hidden-sized all-reduce left is the embedding's vocab-split lookup, as
    in the prefill."""
    cfg = pt_configs.get_arch("smollm-360m")
    train = meshed[("16x16", "smollm-360m/train_4k")]
    prefill = meshed[("16x16", "smollm-360m/prefill_32k")]["collective_counts"]
    hidden = (256 // 16) * 4096 * cfg.d_model * 2
    assert prefill.get("reduce-scatter", 0) > 0
    assert train["collective_counts"].get("reduce-scatter", 0) > 0
    assert hidden <= train["collective_bytes_by_kind"]["all-reduce"] < 2 * hidden


# P8: rank 0 of qwen3-moe-30b-a3b's 16x16 prefill_32k at 2 layers as the card
# traces it (fake CUDA tensors, a cuda mesh; chip_smoke.py phase 8's "[mesh]
# P8" line on an NVIDIA H100 80GB HBM3): its rank peak and collectives by
# kind. The card's PyTorch 2.11 makes 7 all-reduces, this build's 2.13 5: two
# f32 scalars of the moe routing sums that 2.13 does not reduce
CARD_P8 = {"peak": 14035068940, "all-reduces": 7,
           "collectives": {"all-gather": 5, "reduce-scatter": 2, "all-to-all": 4},
           "bytes": {"all-reduce": 5637145608, "all-gather": 1342177280,
                     "reduce-scatter": 33554432, "all-to-all": 10737418240}}
PEAK_TOL = 0.01  # chip_smoke.py's


def test_moe_cpu_trace_has_the_cards_collectives_p8(meshed):
    r = meshed[("16x16", "qwen3-moe-30b-a3b/prefill_32k")]
    assert r["status"] == "ok" and r["traced_on"] == "fake cpu", r.get("error")
    counts, by_kind = r["collective_counts"], r["collective_bytes_by_kind"]
    assert set(counts) == set(CARD_P8["bytes"])  # the experts move by all-to-alls
    assert {k: counts[k] for k in CARD_P8["collectives"]} == CARD_P8["collectives"]
    assert {k: v for k, v in by_kind.items() if k != "all-reduce"} == {
        k: v for k, v in CARD_P8["bytes"].items() if k != "all-reduce"}
    fewer = CARD_P8["all-reduces"] - counts["all-reduce"]
    assert CARD_P8["bytes"]["all-reduce"] - by_kind["all-reduce"] == 4 * fewer
    assert abs(r["peak_memory_bytes"] - CARD_P8["peak"]) <= PEAK_TOL * CARD_P8["peak"]
    assert r["fits_hbm"] is True
