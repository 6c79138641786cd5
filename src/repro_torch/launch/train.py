"""End-to-end DFL training driver of the port (``repro.launch.train``).

N DFL nodes stacked on one device take real steps with a MOSGU gossip
round every ``--gossip-interval`` steps, per-node checkpoints and, with
``--scenario``, a registry scenario's protocol, codec, round count and churn
schedule (moderator rotation every round, replan on churn):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --smoke \\
      --steps 3 --nodes 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --nodes 4 \\
      --scenario mesh_smoke --device cpu --trace trace.json

With ``--sweep NAME`` the run is one cell of a registered experiment grid
(:mod:`repro_torch.scenario.sweep`): ``--cell K`` trains the K-th cell's
scenario, while ``--sweep NAME`` alone prints the grid with its
plan-executor counts (transmissions and wire MB a cell, the reference's
dry table line for line) and exits without touching a device:

  PYTHONPATH=src python -m repro_torch.launch.train --sweep codec_x_protocol
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --nodes 4 \\
      --sweep codec_x_protocol --cell 7 --device cpu

``--nodes N`` stacks N nodes on one device. ``--mesh AxB[xC]`` is the JAX
launcher's: a ``DeviceMesh`` over the ranks of the default process group,
axes ``("pod", "data", "model")[-len(dims):]``, the nodes those of the
config's node axes the mesh has (their count comes from the plan), and the
multi-rank trainer (``dfl/trainer.py::MeshDFLTrainer``): each rank holds
its shards and gossip runs point to point between ranks. It needs
``prod(dims)`` ranks, so the caller starts them (``torchrun``, which the
launcher joins from its environment, or a spawner that initializes the group
first), and refuses ``--nodes``. With ``--device cpu`` the group is gloo's on
the CPU; otherwise each rank takes ``cuda:LOCAL_RANK`` and needs a group
that moves CUDA tensors (NCCL), and fails by name without one. Rank 0
logs; a checkpoint is one file a node, each node's shards gathered over
the other axes and written by that node's first rank (the stacked run's
files). When the node count equals the scenario's, the session plans over
the scenario's own overlay:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2 \
      --device cpu --smoke --steps 3 Without ``--device cpu`` it runs on
the card. ``--warmup`` defaults to 100, the reference's ``DFLConfig``
default, so one command line trains on one lr schedule in both packages
(the cosine warm-up gives lr 0 at step 0 only). ``--trace PATH`` records
the run's host-clock spans (``train:step`` a step; a scenario run records
the session's ``plan:recompile`` and ``train:step``) and writes a validated
Chrome / Perfetto trace at the end.

:func:`build_run` makes the model, trainer, initial state and data of a
parsed command line, and :func:`train` runs it; the CLI, ``chip_smoke.py``
and the tests share both.
"""
from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true", help="use the reduced variant")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-per-node", type=int, default=2)
    ap.add_argument("--nodes", type=int, default=None,
                    help="DFL nodes stacked on the device (default 1)")
    ap.add_argument("--mesh", default="",
                    help="e.g. 2x2 (data x model) or 2x2x2 (pod x data x model): one rank a "
                         "mesh device, in a process group the caller starts")
    ap.add_argument("--gossip", default="tree_allreduce")
    ap.add_argument("--codec", default="", help="gossip wire codec: bf16, int8, int4, topk")
    ap.add_argument("--scenario", default="",
                    help="registry scenario driving protocol / codec / rounds / churn")
    ap.add_argument("--sweep", default="",
                    help="registered sweep grid; with --cell K trains that cell's scenario, "
                         "alone prints the expanded grid "
                         "(see repro_torch.scenario.scenarios.sweep_names())")
    ap.add_argument("--cell", type=int, default=-1,
                    help="cell index into --sweep (the launcher-array slot)")
    ap.add_argument("--gossip-interval", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace", default="",
                    help="record an observability trace of the run and write "
                         "Chrome/Perfetto JSON to this path")
    return ap.parse_args(argv)


@dataclass
class TrainRun:
    """A parsed command line made concrete, and what its training did."""

    args: argparse.Namespace
    scenario: Any  # Optional[ScenarioSpec]
    codec: str
    cfg: Any
    model: Any
    trainer: Any
    state: Any  # the latest TrainState
    make_batch: Callable[[], Any]
    session: Any = None  # DFLSession of a scenario run
    mesh: Any = None  # the DeviceMesh of a --mesh run
    losses: List[float] = field(default_factory=list)
    grad_norms: List[float] = field(default_factory=list)
    # each step's (or scenario round's) seconds by host clock; on the card
    # synchronized at its end, so a round's gossip kernels are inside
    step_s: List[float] = field(default_factory=list)


def print_dry_table(sweep) -> None:
    """The sweep's cells with their plan-executor counts, as the reference
    launcher prints them."""
    from ..scenario.sweep import run_sweep

    result = run_sweep(sweep, executor="plan")
    print(f"sweep {sweep.name!r}: {len(result)} cells (pass --cell K to train one)")
    for row in result.table():
        coords = ",".join(f"{k}={v}" for k, v in row.items() if k in sweep.axes())
        print(f"  [{row['cell']:3d}] {coords:40s} "
              f"tx={row['transmissions']:6d} "
              f"wire={row['bytes_on_wire_mb']:10.1f}MB")


def _lead_print() -> Callable[..., None]:
    """``print`` on the process that logs: rank 0 of a started group (or of
    torchrun's environment before the group starts), else a no-op."""
    import os

    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", 0))
    return print if rank == 0 else (lambda *_, **__: None)


def resolve_scenario(args: argparse.Namespace) -> Tuple[bool, Any]:
    """The scenario a command line names (a ``--sweep`` cell or
    ``--scenario``), with the reference's checks and header lines; sets
    ``args.gossip`` and ``args.steps`` from it. Returns ``(done, scenario)``:
    done when ``--sweep`` alone printed its dry table."""
    from ..scenario import registry
    from ..scenario.spec import resolve_gossip_mode

    if args.sweep and args.scenario:
        raise SystemExit("--sweep and --scenario are mutually exclusive: "
                         "a sweep cell *is* the scenario for the run")
    if args.cell >= 0 and not args.sweep:
        raise SystemExit("--cell is an index into --sweep; pass a sweep name "
                         "(see repro_torch.scenario.scenarios.sweep_names())")
    scenario = None
    if args.sweep:
        sweep = registry.get_sweep(args.sweep)
        cells = sweep.cells()
        if args.cell < 0:
            print_dry_table(sweep)
            return True, None
        if not (0 <= args.cell < len(cells)):
            raise SystemExit(f"--cell {args.cell} outside [0, {len(cells)}) for sweep "
                             f"{sweep.name!r}")
        scenario = cells[args.cell].spec
        log = _lead_print()
        log(f"sweep {sweep.name!r} cell {args.cell}: {scenario.name}")
        args.gossip = resolve_gossip_mode(scenario.protocol)
        args.steps = scenario.rounds
        log(f"cell scenario: protocol={scenario.protocol} "
              f"codec={scenario.codec} rounds={scenario.rounds}")
    elif args.scenario:
        scenario = registry.get(args.scenario)
        args.gossip = resolve_gossip_mode(scenario.protocol)
        args.steps = scenario.rounds
        _lead_print()(f"scenario {scenario.name!r}: protocol={scenario.protocol} "
                      f"codec={scenario.codec} rounds={scenario.rounds} "
                      f"churn={len(scenario.churn)} events")
    return False, scenario


def build_run(args: argparse.Namespace, scenario=None) -> TrainRun:
    """The model, trainer (with its session for a scenario), initial state
    and data of a command line; every node starts from ``Model.init`` with
    seed 0."""
    import torch

    from .. import resolve_device
    from ..configs import get_arch
    from ..data import DataConfig, FederatedData
    from ..dfl.session import DFLSession
    from ..dfl.trainer import DFLConfig, DFLTrainer, MeshDFLTrainer
    from ..models import Batch, build_model

    mesh = None
    if args.mesh:
        if args.nodes is not None:
            raise SystemExit("--nodes and --mesh are mutually exclusive: on a mesh the node "
                             "count comes from the plan over the config's node axes")
        mesh = make_mesh(args.mesh, args.device)
        dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device("cpu")
    else:
        args.nodes = args.nodes or 1
        dev = resolve_device(args.device)
    codec = args.codec
    if scenario is not None:  # the scenario's wire codec ("" = raw fp32)
        codec = scenario.codec if scenario.codec != "fp32" else ""
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke_variant()
    model = build_model(cfg, device=dev)
    dfl = DFLConfig(gossip_mode=args.gossip, gossip_interval=args.gossip_interval, lr=args.lr,
                    warmup=args.warmup, total_steps=args.steps, codec=codec)
    if mesh is not None:
        trainer = MeshDFLTrainer(model, mesh, dfl)
        args.nodes = trainer.n_nodes
    else:
        trainer = DFLTrainer(model, args.nodes, dfl, device=dev)
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    data = FederatedData(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                    batch_per_node=args.batch_per_node, n_nodes=args.nodes))

    def make_batch() -> Batch:
        """The next global batch; whisper's frames and paligemma's patches
        are zeros in f32, as the JAX launcher makes them (the frontends are
        stubs)."""
        tok, lab = data.global_batch()
        kw = {}
        if cfg.family == "audio":
            kw["encoder_frames"] = torch.zeros((tok.shape[0], cfg.n_frames, cfg.d_model),
                                               device=dev)
        if cfg.family == "vlm":
            kw["patch_embeddings"] = torch.zeros((tok.shape[0], cfg.n_patches, cfg.d_model),
                                                 device=dev)
        return Batch(tokens=torch.from_numpy(tok).long().to(dev),
                     labels=torch.from_numpy(lab).long().to(dev), **kw)

    session = DFLSession(trainer, scenario=scenario) if scenario is not None else None
    return TrainRun(args=args, scenario=scenario, codec=codec, cfg=cfg, model=model,
                    trainer=trainer, state=state, make_batch=make_batch, session=session,
                    mesh=mesh)


def make_mesh(spec: str, device: Optional[str]):
    """The ``--mesh AxB[xC]`` DeviceMesh over the default process group,
    joined from torchrun's environment when none is initialized; fails by
    name without enough ranks or without a group that runs on the device."""
    import os

    import torch
    import torch.distributed as dist

    from .mesh import make_local_mesh

    dims = tuple(int(x) for x in spec.split("x"))
    axes = ("pod", "data", "model")[-len(dims):]
    cpu = device == "cpu"
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:  # torchrun
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("gloo" if cpu else "nccl")
    if dist.is_initialized():
        backend = dist.get_backend()
        if cpu and backend == "nccl":
            raise RuntimeError("--mesh with --device cpu needs a gloo process group, the "
                               "default group is NCCL's")
        if not cpu and backend not in ("nccl", "fake"):
            raise RuntimeError(f"--mesh on the card needs an NCCL process group: {backend} "
                               "moves no CUDA tensors point to point (pass --device cpu)")
    return make_local_mesh(dims, axes, device="cpu" if cpu else "cuda")


def train(run: TrainRun) -> TrainRun:
    """Run's steps (or its scenario's rounds through the session), logged as
    the reference launcher logs them."""
    import torch

    from .. import obs
    from ..checkpoint import node_checkpoint_path, save_pytree
    from ..dfl.collectives import tree_map
    from ..optim.optimizers import tree_leaves

    args, trainer, cfg = run.args, run.trainer, run.cfg
    dev = trainer.device
    lead = 0 if run.mesh is None else 1  # the stacked node axis
    n_params = sum(math.prod(t.shape[lead:]) for t in tree_leaves(run.state.params))
    log = _lead_print()
    log(f"arch={cfg.name} params={n_params / 1e6:.1f}M nodes={trainer.n_nodes} "
        f"mst_slots={trainer.plan.dissemination.n_slots} gossip={args.gossip} "
        f"codec={run.codec or 'fp32'} device={dev}"
        + (f" mesh={args.mesh}" if run.mesh is not None else ""))

    def now() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def record(metrics) -> None:
        end = now()
        run.step_s.append(end - marks[-1])
        marks.append(end)
        run.losses.append(float(metrics["loss"]))
        run.grad_norms.append(float(metrics["grad_norm"]))

    batch = run.make_batch()
    marks = [now()]
    if run.session is not None:
        from ..dfl.session import run_scenario_rounds

        run.state, _ = run_scenario_rounds(run.session, run.state, batch, run.make_batch,
                                           on_round=lambda i, m: record(m), log=log)
        log(f"done: {run.scenario.rounds} scenario rounds in {marks[-1] - marks[0]:.1f}s")
        _flush_trace(args.trace)
        return run

    rec = obs.get()
    for i in range(args.steps):
        with rec.span("train:step", cat="train", track="train", step=i,
                      gossip=(i + 1) % max(args.gossip_interval, 1) == 0):
            run.state, metrics = trainer.train_step(run.state, batch)
        record(metrics)
        batch = run.make_batch()
        if (i + 1) % args.log_every == 0 or i == 0:
            log(f"step {i + 1:5d} loss={run.losses[-1]:.4f} "
                f"gnorm={run.grad_norms[-1]:.3f} "
                f"({(marks[-1] - marks[0]) / (i + 1):.2f}s/step)")
        if args.checkpoint_dir and args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            meta = {"step": i + 1, "arch": cfg.name}
            if run.mesh is None:
                for node in range(args.nodes):
                    save_pytree(node_checkpoint_path(args.checkpoint_dir, node, i + 1),
                                tree_map(lambda t: t[node], run.state.params),
                                dict(meta, node=node))
            else:  # every rank gathers; each node's first rank writes its file
                whole = tree_map(lambda t: t.full_tensor(), run.state.params)
                nodes = trainer.plan.nodes
                names = run.mesh.mesh_dim_names
                if all(c == 0 for a, c in zip(names, run.mesh.get_coordinate())
                       if a not in nodes.axes):
                    save_pytree(node_checkpoint_path(args.checkpoint_dir, nodes.node, i + 1),
                                whole, dict(meta, node=nodes.node))
    log(f"done: {args.steps} steps in {marks[-1] - marks[0]:.1f}s, loss "
        + " ".join(f"{x:.4f}" for x in run.losses))
    _flush_trace(args.trace)
    return run


def main(argv: Optional[List[str]] = None) -> Optional[TrainRun]:
    args = parse_args(argv)
    from .. import obs

    if args.trace:
        obs.set_recorder(obs.Recorder())
    done, scenario = resolve_scenario(args)
    if done:
        return None
    return train(build_run(args, scenario))


def _flush_trace(path: str) -> None:
    """Uninstall the run's recorder and export it as a Perfetto trace
    (validated before it is written)."""
    if not path:
        return
    from .. import obs

    rec = obs.set_recorder(obs.NULL_RECORDER)
    obs.write_trace(rec, path)
    print(f"wrote {path} ({len(rec.spans)} spans) — open in ui.perfetto.dev")


if __name__ == "__main__":
    main()
