"""The port's one-card dry run (``repro_torch.launch.dryrun``) and the config
counts it rests on.

* ``active_param_count``, ``param_count`` and ``input_specs`` equal the JAX
  package's for every arch and every ``INPUT_SHAPES`` entry, exactly.
* For the smoke variant of every family, ``dryrun_pair`` traces one DFL
  train step on fake tensors (``status == "ok"``) and its FLOPs and kernel
  launches equal the op counter's on a real CPU step of the same config,
  exactly; the trace reaches no kernel library and no plain version.
* Prefill and decode trace for every family; ``long_500k`` is skipped for
  whisper-tiny, as the reference's dry run skips it.
* The dry run's CUDA device: ``resolve_device`` gives it only while the dry
  run's fake mode is active.
* ``--mesh 16x16``: every arch at 2 layers traces rank 0's prefill and
  decode (``ok``, with its FLOPs, bytes, collectives and ``fits_hbm``), and
  its peak and FLOPs are below the one-card dry run's at the same cut; a
  training shape is ``not_ported`` (ROADMAP A7b). ``2x16x16`` is held in
  ``tests/test_torch_op_analysis.py``. Files end ``__multipod.json`` /
  ``__singlepod.json``, as the JAX dry run's.
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


@pytest.fixture(scope="module")
def meshed():
    return _run_meshes([("16x16", MESH_ARCHS), ("1xH100", MESH_ARCHS)])


@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_meshed_dry_run_16x16(meshed, arch, shape):
    r = meshed[("16x16", f"{arch}/{shape}")]
    if shape == "train_4k":
        assert r["status"] == "not_ported" and "A7b" in r["reason"], r
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
    assert res["status"] == "not_ported" and res["mesh"] == "2x16x16" and res["n_chips"] == 512
