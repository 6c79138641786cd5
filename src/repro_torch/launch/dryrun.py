"""One-card dry run: trace every (arch × shape) on fake tensors and report
what one NVIDIA H100 would do (``repro.launch.dryrun`` for the port).

For each pair, with no card needed, it reports:
  * the peak of live tensor bytes and whether it fits the card's memory
    (``fits_hbm``). Both count the step's tensors only: they leave out the
    CUDA context, cuBLAS's workspaces and the caching allocator's rounding,
    which ``chip_smoke.py`` phase 7 measures on the card,
  * the FLOPs and bytes of one step and the roofline terms at H100
    constants (``launch/roofline.py``),
  * the launches of every hand-written kernel,
  * for training shapes, the gossip plan's analytic bytes.

Training shapes trace the DFL trainer's state as a gossip round leaves it
(an f32 parameter shares its master's storage) and one gossiping
``DFLTrainer.train_step`` (the step itself, not a copy of it); prefill
traces ``Model.forward``; decode ``init_cache`` and one ``decode_step``.
The trace runs under a ``FakeTensorMode``, counted by
``launch/op_analysis.py``'s ``OpCounter``: the tensors carry shapes, dtypes
and a device but no data, every kernel takes its fake route, and nothing
touches a card. It states what a step would cost; it is not a run on one.

The fake tensors claim ``cuda`` where a card is visible and the CPU
elsewhere: without one PyTorch cannot differentiate fake CUDA tensors (a
build without CUDA lacks the CUDA device guard that indexing and autograd
ask for; a CUDA build's autograd engine checks the device index). Both
take the kernels' fake route and count the same.

With ``--mesh 16x16`` or ``--mesh 2x16x16`` (``--multi-pod``, the JAX
spelling) it traces rank 0 of the JAX dry run's production layouts
(``launch/mesh.py``) instead: a ``"fake"`` process group of 256 or 512
ranks (collectives move no data), the params, batch and cache DTensors made
from rank 0's own shards by the spec trees (``dfl/sharding.py``), and one
prefill or decode step of the meshed model. Every count is the rank's: its
FLOPs, bytes and peak, its kernel launches on its local heads and channels,
its collectives by kind with their bytes (the roofline's collective term).
A training shape traces rank 0's whole step of the meshed trainer
(``dfl/trainer.py::MeshDFLTrainer``): its microbatches, the gradients'
reductions, the optimizer and the gossip round between ranks, whose
point-to-point sends count under the kind ``collective-permute`` (the JAX
roofline's name for a ``ppermute``); the ``gossip`` block adds the plan's
nodes and slots, each mode's analytic bytes and the rank's point-to-point
share (``rank_p2p_bytes``). A pair whose rank peak exceeds the card says so
(``reason``). Files end ``__singlepod.json`` or ``__multipod.json``, as the
JAX dry run's. A mesh traced on the CPU is a ``cpu`` DeviceMesh; under the
fake group DTensor's move of a shard between dimensions is made the card's
all-to-all there (:func:`card_alltoall`; its own CPU route gathers, gloo
having no all-to-all), so the CPU trace has the card's collectives and
peak.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k --nodes 4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 16x16
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from ..compress import make_codec
from ..configs import INPUT_SHAPES, InputShape, get_arch, input_specs, list_archs
from ..dfl.collectives import GossipPlan, gossip_collective_bytes, rank_gossip_bytes, tree_map
from ..dfl.sharding import (batch_axes, batch_spec, local_param_tree, local_zeros_tree,
                            param_shapes, param_spec_tree)
from ..dfl.trainer import DFLConfig, DFLTrainer, MeshDFLTrainer, TrainState, recast
from ..models import Batch, build_model
from .mesh import make_production_mesh
from .op_analysis import OpCounter, tensors
from .roofline import HBM_BYTES, Roofline, model_flops_for, wire_bytes

MESH = "1xH100"
MESHES = {"16x16": (False, 256), "2x16x16": (True, 512)}  # name -> (multi_pod, ranks)
MESH_TAGS = {"16x16": "singlepod", "2x16x16": "multipod"}
GOSSIP_MODES = ("dissemination", "tree_allreduce", "mixing", "flooding", "allreduce_ref")


def trace_device() -> torch.device:
    """``cuda`` where a card is visible, else the CPU (see the module
    docstring)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def card_memory() -> int:
    """The card's memory where one is present, else the H100's 80 GB."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return int(HBM_BYTES)


def _inputs(cfg, shape: InputShape, dev: torch.device) -> Dict[str, torch.Tensor]:
    """Zero tensors of :func:`input_specs`' shapes as the launcher feeds the
    model: token ids int64, the stubbed frontends' embeddings (whisper's
    frames, paligemma's patches) in f32 (``launch/train.py``'s batches)."""
    out = {}
    for name, (dims, dtype) in input_specs(cfg, shape, torch.int64).items():
        out[name] = torch.zeros(dims, dtype=torch.float32 if dtype.is_floating_point else dtype,
                                device=dev)
    return out


def fake_group(ranks: int) -> None:
    """A ``"fake"`` default process group of at least ``ranks`` ranks, this
    process its rank 0 (one is made, or a smaller fake one remade)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() >= ranks:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"the dry run needs {ranks} ranks; the process group has "
                               f"{dist.get_world_size()}")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=ranks)


@contextlib.contextmanager
def card_alltoall(mesh_device: str):
    """On a ``cpu`` mesh under the ``"fake"`` group, DTensor's move of a
    shard between dimensions as the card makes it: one all-to-all
    (``_dtensor::shard_dim_alltoall``), where DTensor's CPU route gathers
    the whole tensor and keeps a chunk (gloo has no all-to-all). The trace
    then has the card's collectives by kind and its peak; the identity on
    any other mesh."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    if mesh_device != "cpu" or dist.get_backend() != "fake":
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._group_or_group_name(funcol._resolve_group((mesh, mesh_dim)))
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim, group)

    saved = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = saved


def dryrun_pair(
    arch: str,
    shape_name: str,
    *,
    mesh: str = MESH,
    nodes: int = 4,
    layers: Optional[int] = None,
    batch: Optional[int] = None,
    seq: Optional[int] = None,
    gossip_mode: str = "tree_allreduce",
    arch_overrides: Optional[Dict[str, Any]] = None,
    dfl_overrides: Optional[Dict[str, Any]] = None,
    smoke: bool = False,
    verbose: bool = True,
) -> Dict[str, Any]:
    """One (arch, shape) on one H100, or (``mesh`` "16x16" / "2x16x16") on
    rank 0 of that layout (:func:`meshed_pair`). ``layers``, ``batch`` (the
    global batch: ``nodes`` x rows a node for a training shape) and ``seq``
    cut the config and the shape; arch_overrides: ArchConfig.replace kwargs;
    dfl_overrides: DFLConfig kwargs (codec, lr, warmup, ...); smoke: the
    config's smoke variant."""
    cfg = get_arch(arch).smoke_variant() if smoke else get_arch(arch)
    if arch_overrides:
        cfg = cfg.replace(**arch_overrides)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    base = INPUT_SHAPES[shape_name]
    shape = InputShape(base.name, seq or base.seq_len, batch or base.global_batch, base.kind)
    if mesh != MESH:
        return meshed_pair(arch, cfg, shape, mesh, gossip_mode=gossip_mode,
                           dfl_overrides=dfl_overrides, verbose=verbose)
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": MESH, "n_chips": 1,
        "gossip_mode": gossip_mode, "status": "ok", "n_layers": cfg.n_layers,
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
    }
    if shape_name in cfg.skip_shapes:
        result["status"] = "skipped"
        result["reason"] = "see DESIGN.md §Arch-applicability"
        return result
    t0 = time.time()
    dev = trace_device()
    result["traced_on"] = f"fake {dev.type}"
    try:
        with FakeTensorMode():  # resolve_device gives CUDA inside it
            model = build_model(cfg, shape_name, device=dev)
            params = tree_map(lambda t: torch.empty_like(t, device=dev),
                              model.init(torch.Generator().manual_seed(0)))
            inputs = _inputs(cfg, shape, dev)
            if shape.kind == "train":
                dflc = DFLConfig(gossip_mode=gossip_mode, **(dfl_overrides or {}))
                trainer = DFLTrainer(model, nodes, dflc, device=dev)
                state = trainer.state_from_params(params)
                del params
                if "master" in state.opt_state:  # the state a gossip round leaves
                    state.params = recast(state.opt_state["master"], state.params)
                data = Batch(**inputs)
                with OpCounter(live=(state, data), device=dev.type) as counter:
                    state, _ = trainer.train_step(state, data)
            elif shape.kind == "prefill":
                data = Batch(**inputs)
                with torch.inference_mode(), OpCounter(live=(params, data),
                                                       device=dev.type) as counter:
                    model.forward(params, data)
            else:
                b = shape.global_batch
                cache = model.init_cache(b, shape.seq_len)
                tok = inputs["tokens"]
                pos = torch.full((b,), shape.seq_len - 1, dtype=torch.int64, device=dev)
                with torch.inference_mode(), OpCounter(live=(params, cache, tok, pos),
                                                       device=dev.type) as counter:
                    model.decode_step(params, tok, pos, cache)
        stats = counter.stats
        plan = GossipPlan.build(nodes) if shape.kind == "train" else None
        pbytes = cfg.param_count() * (2 if cfg.dtype == "bfloat16" else 4)
        coll = 0.0
        if plan is not None:
            codec = (dfl_overrides or {}).get("codec")
            coll = gossip_collective_bytes(gossip_mode, plan, pbytes,
                                           make_codec(codec) if codec else None) / nodes
        roof = Roofline(arch, shape_name, MESH, 1, stats.flops, stats.bytes, coll,
                        float(stats.peak_bytes), model_flops_for(cfg, shape, shape.kind),
                        dict(stats.launches))
        result.update(roof.as_dict())
        result.update(trace_s=round(time.time() - t0, 1), fits_hbm=bool(
            stats.peak_bytes <= card_memory()), start_memory_bytes=stats.start_bytes,
            aten_calls=sum(stats.calls_by_op.values()), top_flops=stats.top(),
            bytes_by_op=dict(stats.bytes_by_op))
        if plan is not None:
            result["gossip"] = {
                "n_nodes": plan.n_nodes,
                "mode": gossip_mode,
                "mst_slots": plan.dissemination.n_slots,
                "tree_slots": plan.tree.n_slots,
                "analytic_bytes": {m: gossip_collective_bytes(m, plan, pbytes)
                                   for m in GOSSIP_MODES},
            }
        if verbose:
            print(f"[{arch} × {shape_name} × {MESH}] OK traced {result['trace_s']}s "
                  f"peak={stats.peak_bytes / 2**30:.2f}GiB compute={roof.compute_s * 1e3:.2f}ms "
                  f"memory={roof.memory_s * 1e3:.2f}ms collective={roof.collective_s * 1e3:.2f}ms"
                  f" -> {roof.bottleneck}")
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-6000:]
        if verbose:
            print(f"[{arch} × {shape_name} × {MESH}] FAILED: {result['error']}")
    return result


def meshed_pair(arch: str, cfg, shape: InputShape, mesh_name: str, *,
                gossip_mode: str = "tree_allreduce",
                dfl_overrides: Optional[Dict[str, Any]] = None,
                verbose: bool = True) -> Dict[str, Any]:
    """One (arch, shape) on rank 0 of the ``mesh_name`` layout: the prefill
    or decode step of the meshed model, or the meshed trainer's step
    (:func:`meshed_train_step`), on rank 0's shards, traced on fake tensors
    under a fake process group (see the module docstring)."""
    multi_pod, ranks = MESHES[mesh_name]
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name, "n_chips": ranks,
        "status": "ok", "n_layers": cfg.n_layers, "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
    }
    if shape.name in cfg.skip_shapes:
        result.update(status="skipped", reason="see DESIGN.md §Arch-applicability")
        return result
    t0 = time.time()
    dev = trace_device()
    result["traced_on"] = f"fake {dev.type}"
    model = None
    try:
        fake_group(ranks)
        dmesh = make_production_mesh(multi_pod=multi_pod, device=dev)
        with FakeTensorMode(), card_alltoall(dev.type):
            model = build_model(cfg, shape.name, device=dev)
            b = shape.global_batch
            model.set_mesh_context(dmesh, batch_axes(dmesh, b))
            shapes = param_shapes(model)
            params = local_param_tree(cfg, dmesh, shapes, param_spec_tree(cfg, shapes, dmesh),
                                      device=dev)
            if shape.kind == "train":
                trainer = MeshDFLTrainer(model, dmesh, DFLConfig(gossip_mode=gossip_mode,
                                                                 **(dfl_overrides or {})))
                state = meshed_train_state(trainer, params)
                del params
                counter, result["gossip"], _ = meshed_train_step(
                    trainer, state, Batch(**_inputs(cfg, shape, dev)))
                del state
            else:
                counter = run_meshed_step(model, params,
                                          meshed_inputs(model, shape, dmesh, dev))
        stats = counter.stats
        roof = Roofline(arch, shape.name, mesh_name, ranks, stats.flops, stats.bytes,
                        wire_bytes(stats.collective_bytes), float(stats.peak_bytes),
                        model_flops_for(cfg, shape, shape.kind), dict(stats.launches),
                        dict(stats.collectives))
        result.update(roof.as_dict())
        result.update(trace_s=round(time.time() - t0, 1),
                      fits_hbm=bool(stats.peak_bytes <= card_memory()),
                      start_memory_bytes=stats.start_bytes,
                      collective_bytes_by_kind=dict(stats.collective_bytes),
                      batch_axes=list(batch_axes(dmesh, shape.global_batch)),
                      aten_calls=sum(stats.calls_by_op.values()), top_flops=stats.top(),
                      top_bytes=dict(stats.bytes_by_op.most_common(6)),
                      bytes_by_op=dict(stats.bytes_by_op))
        if not result["fits_hbm"]:
            result["reason"] = (f"rank peak {stats.peak_bytes / 1e9:.2f} GB over the card's "
                                f"{card_memory() / 1e9:.1f} GB")
        if verbose:
            print(f"[{arch} × {shape.name} × {mesh_name}] OK traced {result['trace_s']}s "
                  f"rank peak={stats.peak_bytes / 2**30:.2f}GiB "
                  f"compute={roof.compute_s * 1e3:.2f}ms memory={roof.memory_s * 1e3:.2f}ms "
                  f"collective={roof.collective_s * 1e3:.2f}ms -> {roof.bottleneck}")
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-6000:]
        if verbose:
            print(f"[{arch} × {shape.name} × {mesh_name}] FAILED: {result['error']}")
    finally:
        if model is not None:
            model.set_mesh_context(None)
    return result


def meshed_inputs(model, shape: InputShape, dmesh, dev: torch.device) -> Tuple[Any, ...]:
    """A meshed step's inputs, zero, made from each rank's shards split on
    the batch axes (:func:`batch_spec`), in :func:`_inputs`' dtypes: (the
    ``Batch``,) for a prefill; (tokens, positions at the cache's last slot,
    ``init_cache``'s cache) for a decode step."""
    shapes = _inputs(model.cfg, shape, torch.device("meta"))
    specs = {k: batch_spec(dmesh, v.shape[0], v.ndim) for k, v in shapes.items()}
    data = local_zeros_tree(dmesh, shapes, specs, device=dev)
    if shape.kind == "prefill":
        return (Batch(**data),)
    b = shape.global_batch
    pos = local_zeros_tree(dmesh, torch.zeros((b,), dtype=torch.int64, device="meta"),
                           batch_spec(dmesh, b, 1), device=dev)
    with torch.no_grad():
        pos = pos + (shape.seq_len - 1)
    return data["tokens"], pos, model.init_cache(b, shape.seq_len)


def meshed_train_state(trainer: MeshDFLTrainer, params) -> TrainState:
    """The meshed trainer's state from ``params`` (rank 0's DTensors) as a
    gossip round leaves it: an f32 parameter shares its master's storage."""
    state = trainer.state_from_params(params)
    if "master" in state.opt_state:
        state.params = recast(state.opt_state["master"], state.params)
    return state


def meshed_train_step(trainer: MeshDFLTrainer, state: TrainState, batch: Batch
                      ) -> Tuple[OpCounter, Dict[str, Any], Dict[str, Any]]:
    """One gossiping step of the meshed trainer on the global ``batch``
    under the op counter (its live tensors: ``state`` and the batch; the
    step consumes the state). Returns the counter, the plan's ``gossip``
    block (its nodes and slots, each mode's analytic bytes,
    ``gossip_collective_bytes``, and this rank's point-to-point share of the
    step's mode, ``rank_gossip_bytes``) and the step's metrics. The dry run
    calls it on fake tensors, ``chip_smoke.py`` on the card's."""
    plan, cfg, dflc = trainer.plan, trainer.cfg, trainer.dfl
    theta = state.opt_state.get("master", state.params)
    pbytes = cfg.param_count() * (2 if cfg.dtype == "bfloat16" else 4)
    wire = torch.bfloat16 if dflc.wire_dtype == "bfloat16" else None
    gossip = {
        "n_nodes": plan.n_nodes,
        "node_axes": list(plan.nodes.axes),
        "mode": dflc.gossip_mode,
        "codec": dflc.codec or "fp32",
        "mst_slots": plan.dissemination.n_slots,
        "tree_slots": plan.tree.n_slots,
        "analytic_bytes": {m: gossip_collective_bytes(m, plan, pbytes) for m in GOSSIP_MODES},
        "rank_p2p_bytes": rank_gossip_bytes(dflc.gossip_mode, plan,
                                            tree_map(lambda t: t.to_local(), theta),
                                            wire_dtype=wire, codec=trainer.codec),
    }
    del theta
    dev = next(iter(tensors(state))).device
    with OpCounter(live=(state, batch), device=dev.type) as counter:
        state, metrics = trainer.train_step(state, batch)
    return counter, gossip, metrics


def run_meshed_step(model, params, inputs: Tuple[Any, ...]) -> OpCounter:
    """One prefill (``Model.forward``) or decode step (``decode_step``) of a
    meshed model on :func:`meshed_inputs`, under the op counter (its live
    tensors: the params and the inputs); returns the counter. The dry run
    calls it on fake tensors, ``chip_smoke.py`` on the card's."""
    dev = next(iter(tensors(params))).device
    with torch.no_grad():  # DTensor views cannot cross into inference mode
        with OpCounter(live=(params, inputs), device=dev.type) as counter:
            if len(inputs) == 1:
                model.forward(params, inputs[0])
            else:
                model.decode_step(params, *inputs)
    return counter


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list_archs() + [None])
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true", help="sweep all arch × shape")
    ap.add_argument("--nodes", type=int, default=4, help="stacked DFL nodes (training)")
    ap.add_argument("--layers", type=int, default=None, help="cut depth")
    ap.add_argument("--batch", type=int, default=None, help="global batch")
    ap.add_argument("--seq", type=int, default=None, help="sequence length")
    ap.add_argument("--gossip", default="tree_allreduce")
    ap.add_argument("--smoke", action="store_true", help="the configs' smoke variants")
    ap.add_argument("--mesh", default=MESH, choices=[MESH, *MESHES],
                    help="one card (default) or rank 0 of a production layout")
    ap.add_argument("--multi-pod", action="store_true", help="--mesh 2x16x16")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    mesh = "2x16x16" if args.multi_pod else args.mesh

    if args.all:
        pairs = [(a, s) for a in list_archs() for s in INPUT_SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        pairs = [(args.arch, args.shape)]
    os.makedirs(args.out, exist_ok=True)
    failed = 0
    for arch, shape in pairs:
        res = dryrun_pair(arch, shape, mesh=mesh, nodes=args.nodes, layers=args.layers,
                          batch=args.batch, seq=args.seq, gossip_mode=args.gossip,
                          smoke=args.smoke)
        failed += res["status"] == "error"
        tag = MESH_TAGS.get(mesh, mesh)
        with open(os.path.join(args.out, f"{arch}__{shape}__{tag}.json"), "w") as f:
            json.dump(res, f, indent=2, default=str)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
