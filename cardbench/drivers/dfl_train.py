"""The driver of ``dfl_train`` traffic: the port's DFL training step,
``repro_torch.dfl.trainer.DFLTrainer.train_step``, on N nodes stacked on
one card.

One run: the kernel library built or loaded (its build timed apart); the
configuration's weights drawn on the card from the seed (the benchmark's,
``reference/weights.py``), each node's moved by a drift of its own
(``node_drift``), handed to a new trainer; a pool of
non-IID global batches from the seed (``traffic.py``); the first
``checked_steps`` steps through ``train_step`` on the pool's first batches,
their losses, the first gradient's leaf norms and the masters' change
recorded for the check; ``warm_steps`` more; then the window: steps on the
pool's batches in turn until ``seconds`` have passed, a CUDA event on the
stream at every step boundary and, traced, around the step's three phases
(``trainer.grads``, ``trainer.opt.update``, ``trainer.gossip``, wrapped on
the instance), nothing read back to the host. A traced run then profiles
``profiled_steps`` more. Last, with the program's state freed, the
reference follows the checked steps.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Any, Dict, List

import torch

import check
import traffic as traffic_gen
from reference import dfl as ref_dfl
from reference.numerics import MATMULS, fp32_strict
from reference.weights import flatten, hyper, make_params, node_params

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_config(cfg: Dict[str, Any]):
    """The port's ``ArchConfig`` for the configuration file: its family's
    preset with every size the file states."""
    from repro_torch.configs import get_arch

    hp = hyper(cfg)
    if hp["rms_norm_eps"] != 1e-6:
        raise ValueError("the port's RMS norm runs eps 1e-6 only")
    opt = cfg["optimizer"]
    kw: Dict[str, Any] = dict(n_layers=hp["num_hidden_layers"], d_model=hp["hidden_size"],
                              vocab=hp["vocab_size"], dtype=cfg["dtype"], remat=cfg["remat"],
                              optimizer=opt["kind"], optimizer_dtype=opt["moment_dtype"],
                              use_master_fp32=opt["master_fp32"], microbatches=1)
    if cfg["reference"] == "dense":
        kw.update(n_heads=hp["num_attention_heads"], n_kv_heads=hp["num_key_value_heads"],
                  head_dim=hp["hidden_size"] // hp["num_attention_heads"],
                  d_ff=hp["intermediate_size"], rope_theta=hp["rope_theta"])
    else:
        kw.update(d_inner_mult=hp["intermediate_size"] // hp["hidden_size"],
                  ssm_state=hp["state_size"], conv_width=hp["conv_kernel"])
    arch = get_arch(cfg["port_arch"]).replace(**kw)
    if cfg["reference"] == "mamba1" and (arch.dt_rank != hp["time_step_rank"]
                                         or arch.d_inner != hp["intermediate_size"]):
        raise ValueError(f"the port's Mamba1 block derives dt_rank {arch.dt_rank} and d_inner "
                         f"{arch.d_inner}; the configuration states {hp['time_step_rank']} "
                         f"and {hp['intermediate_size']}")
    return arch


def kernel_library() -> float:
    """Build (on a checkout's first run) or load the program's kernel
    library; the seconds its build took, 0 when it was already built."""
    from repro_torch.kernels import _build

    built = _build.build()
    _build.lib()
    return built


def build(cfg: Dict[str, Any], traffic: Dict[str, Any], device):
    """The port's model and trainer for the cell (no state yet)."""
    from repro_torch.dfl.trainer import DFLConfig, DFLTrainer
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import adamw, cosine_schedule

    arch = port_config(cfg)
    opt = cfg["optimizer"]
    optimizer = adamw(cosine_schedule(traffic["lr"], traffic["warmup"], traffic["total_steps"],
                                      opt["final_frac"]),
                      b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                      weight_decay=opt["weight_decay"], moment_dtype=DTYPES[opt["moment_dtype"]],
                      master_fp32=opt["master_fp32"])
    dfl = DFLConfig(gossip_mode=traffic["gossip_mode"], gossip_interval=traffic["gossip_interval"],
                    max_grad_norm=traffic["max_grad_norm"], codec=traffic["codec"],
                    lr=traffic["lr"], warmup=traffic["warmup"], total_steps=traffic["total_steps"])
    model = Model(arch, device=device)
    return DFLTrainer(model, traffic["nodes"], dfl, optimizer=optimizer, device=device)


def device_pool(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, device) -> List[Any]:
    """The seed's pool of global batches on ``device`` as the port's ``Batch``."""
    from repro_torch.models.model import Batch

    return [Batch(tokens=torch.from_numpy(t).long().to(device),
                  labels=torch.from_numpy(l).long().to(device))
            for t, l in traffic_gen.pool(hyper(cfg)["vocab_size"], traffic, seed)]


def node_start(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, node: int, device):
    """Node ``node``'s starting weights, the same for the program and the
    reference."""
    return node_params(cfg, traffic["node_drift"], seed, node, device)


def _leaf_norms(tree, scale: float = 1.0) -> torch.Tensor:
    return torch.stack([t.float().norm() * scale for _, t in flatten(tree)])


def _change_norms(master, cfg, traffic, seed, device) -> torch.Tensor:
    """Each leaf's norm of the (N, ...) masters less each node's start."""
    sq = 0.0
    for i in range(traffic["nodes"]):
        start = node_start(cfg, traffic, seed, i, device)
        sq = sq + torch.stack([(m[i] - s.float()).square().sum()
                               for (_, m), (_, s) in zip(flatten(master), flatten(start))])
        del start
    return torch.sqrt(sq)


def start_state(trainer, cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, device):
    """The trainer's state from the seed's weights, each node's row of the
    parameters and masters set to its own start. Returns (state, the leaf
    paths, each leaf's elements a node)."""
    params = make_params(cfg, seed, device)
    sizes = [t.numel() for _, t in flatten(params)]
    paths = [p for p, _ in flatten(params)]
    state = trainer.state_from_params(params)
    del params
    rows = [flatten(state.params)]
    if "master" in state.opt_state:
        rows.append(flatten(state.opt_state["master"]))
    with torch.no_grad():
        for i in range(traffic["nodes"]):
            start = flatten(node_start(cfg, traffic, seed, i, device))
            for tree in rows:
                for (_, row), (_, t) in zip(tree, start):
                    row[i].copy_(t)
            del start
    return state, paths, sizes


def checked_steps(trainer, cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, device,
                  pool: List[Any]):
    """The start state (``start_state``) driven through ``train_step`` on the
    pool's first ``checked_steps`` batches. Returns (state, the program's
    record for the check as device tensors, each leaf's elements a node)."""
    state, paths, sizes = start_state(trainer, cfg, traffic, seed, device)
    b1 = cfg["optimizer"]["b1"]
    losses, node_losses, first_grad = [], None, None
    for k in range(traffic["checked_steps"]):
        state, metrics = trainer.train_step(state, pool[k % len(pool)])
        losses.append(metrics["loss"])
        if k == 0:
            node_losses = torch.stack(metrics["node_losses"])
            first_grad = _leaf_norms(state.opt_state["m"], 1.0 / (1.0 - b1))
    change = _change_norms(state.opt_state["master"], cfg, traffic, seed, device)
    return state, {"paths": paths, "losses": torch.stack(losses), "node_losses": node_losses,
                   "first_grad": first_grad, "change": change}, sizes


def host_record(rec: Dict[str, Any]) -> Dict[str, Any]:
    """The program's record read back: by leaf path, as the reference's."""
    paths = rec["paths"]
    return {"losses": rec["losses"].tolist(), "node_losses": [rec["node_losses"].tolist()],
            "first_grad": dict(zip(paths, rec["first_grad"].tolist())),
            "change": dict(zip(paths, rec["change"].tolist()))}


def reference(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, device,
              precision: str = "fp32") -> Dict[str, Any]:
    """The reference's checked steps from the seed's weights and rows."""
    fp32_strict()
    batches = [(torch.from_numpy(t).long().to(device), torch.from_numpy(l).long().to(device))
               for t, l in traffic_gen.pool(hyper(cfg)["vocab_size"], traffic,
                                            seed)[:traffic["checked_steps"]]]
    starts = [node_start(cfg, traffic, seed, i, device) for i in range(traffic["nodes"])]
    return ref_dfl.run_steps(cfg, traffic, starts, batches, MATMULS[precision])


class _Stamp:
    """A CUDA event recorded on the current stream (no sync); on the CPU,
    where the tests drive a run, the host clock."""

    def __init__(self, device):
        self.ev = None
        if torch.device(device).type == "cuda":
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record()
        else:
            self.t = time.perf_counter()

    def ms_to(self, later: "_Stamp") -> float:
        return self.ev.elapsed_time(later.ev) if self.ev else (later.t - self.t) * 1e3


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Phases:
    """Stamps around the step's three phases, recorded on the stream by
    wrappers set on the trainer instance (no sync)."""

    def __init__(self, trainer, device):
        self.trainer, self.device, self.marks = trainer, device, []
        opt = trainer.opt

        def mark(fn, first: bool):
            def run(*args, **kw):
                if first:
                    self._event()
                out = fn(*args, **kw)
                self._event()
                return out
            return run

        trainer.grads = mark(trainer.grads, True)
        trainer.opt = dataclasses.replace(opt, update=mark(opt.update, False))
        trainer.gossip = mark(trainer.gossip, False)
        self._opt = opt

    def _event(self) -> None:
        self.marks.append(_Stamp(self.device))

    def close(self) -> Dict[str, List[float]]:
        """Restore the trainer; each phase's ms a step (every step gossips)."""
        del self.trainer.grads, self.trainer.gossip
        self.trainer.opt = self._opt
        ev = self.marks
        if len(ev) % 4:
            raise RuntimeError(f"{len(ev)} phase events: a step skipped a phase")
        out: Dict[str, List[float]] = {"fwd_bwd": [], "optimizer": [], "gossip": []}
        for i in range(0, len(ev), 4):
            out["fwd_bwd"].append(ev[i].ms_to(ev[i + 1]))
            out["optimizer"].append(ev[i + 1].ms_to(ev[i + 2]))
            out["gossip"].append(ev[i + 2].ms_to(ev[i + 3]))
        return out


def run(cell: Dict[str, Any], cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int,
        seconds: float, trace: bool, t_start: float, device="cuda") -> Dict[str, Any]:
    """One run of the cell; returns the context the metric readers read and
    the check's rows."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import profiled

    on_card = torch.device(device).type == "cuda"
    parts: Dict[str, float] = {}
    last = [t_start]

    def part(name: str, sync: bool = True) -> None:
        if sync:
            _sync(device)
        now = time.perf_counter()
        parts[name] = now - last[0]
        last[0] = now

    part("imports", sync=False)
    part("cuda")  # the first synchronize creates the context
    build_s = kernel_library() if on_card else 0.0
    part("library")
    trainer = build(cfg, traffic, device)
    part("trainer")
    pool = device_pool(cfg, traffic, seed, device)
    part("pool")
    state, prog, sizes = checked_steps(trainer, cfg, traffic, seed, device, pool)
    part("checked_steps")
    k = traffic["checked_steps"]
    for _ in range(traffic["warm_steps"]):
        state, _ = trainer.train_step(state, pool[k % len(pool)])
        k += 1
    part("warm_steps")
    setup_s = time.perf_counter() - t_start

    phases = _Phases(trainer, device) if trace else None
    losses = []
    t0 = time.perf_counter()
    marks = [_Stamp(device)]
    while time.perf_counter() - t0 < seconds:
        state, metrics = trainer.train_step(state, pool[k % len(pool)])
        k += 1
        marks.append(_Stamp(device))
        losses.append(metrics["loss"])
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    step_ms = [a.ms_to(b) for a, b in zip(marks[:-1], marks[1:])]
    phase_ms = phases.close() if phases else None
    failed = sum(not math.isfinite(x) for x in torch.stack(losses).tolist())

    rec = None
    if trace:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            with record_function(profiled.RANGE):
                for _ in range(traffic["profiled_steps"]):
                    state, _ = trainer.train_step(state, pool[k % len(pool)])
                    k += 1
                _sync(device)
        rec = profiled.record(prof)
        del prof

    program = host_record(prog)
    del state, trainer, pool, prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    values = check.readings(program, reference(cfg, traffic, seed, device), cell.get("leaves"))
    ok, rows = check.judge(values, cell["limits"])

    t = traffic
    return {
        "config": cfg, "hyper": hyper(cfg), "traffic": t,
        "setup_s": setup_s, "build_s": build_s, "setup_parts": parts,
        "window_s": window_s, "steps": len(step_ms),
        "tokens_per_step": t["nodes"] * t["rows_per_node"] * t["seq_len"],
        "step_ms": step_ms, "phase_ms": phase_ms, "peak_bytes": peak,
        "profile": rec, "profiled_steps": t["profiled_steps"], "leaf_sizes": sizes,
        "attempted": len(step_ms), "failed": failed, "correct": ok and failed == 0,
        "checked": rows,
    }
