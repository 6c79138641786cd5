"""The scenario front door: one declared spec, any registered executor
(the reference's ``repro.scenario.runner``).

``run_scenario(spec, executor=...)`` looks the executor up in the registry
(:mod:`repro_torch.scenario.executors`: ``plan``, ``engine``, ``netsim``,
``device``, ``event``; the reference's ``jax`` names ``device``) and hands
it the spec; the moderator lifecycle lives once, in
:meth:`~repro_torch.scenario.executors.Executor.execute`. A card run is
``run_scenario(spec, executor=DeviceExecutor(seed=1))``; its card view
(each round's ``device_ms``, the epoch plans) is the executor's ``run``.

:func:`compare_protocols` is the reference runner's function of that name
(the paper's two-column tables on the fluid simulator), which
``repro_torch.core.netsim.compare_protocols`` delegates to.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..core.graph import TopologySpec
from ..core.netsim import SimResult, TestbedSpec
from ..dfl.collectives import tree_flatten, tree_map
from . import executors
from .cache import PlanCache
from .executors import Executor, check_fedavg
from .registry import get
from .spec import ScenarioResult, ScenarioSpec


def run_scenario(spec: Union[str, ScenarioSpec], executor: Union[str, Executor] = "engine",
                 record_trace: bool = False, plan_cache: Optional[PlanCache] = None,
                 verify: str = "off") -> ScenarioResult:
    """Run a declared scenario (or a registry name) on one executor: a
    registry name (``executors.names()``, or the reference's ``"jax"``) or
    an :class:`~repro_torch.scenario.executors.Executor` instance.
    ``plan_cache`` shares the overlay, its search and the plans with other
    runs (a fresh cache when omitted).

    ``verify`` statically proves every epoch's plan on the run's cache
    before the first round (:mod:`repro_torch.verify`): ``"strict"`` raises
    :class:`~repro_torch.verify.VerificationError` on the first violated
    invariant, so a violating plan never reaches the card; ``"warn"``
    downgrades it to a :class:`~repro_torch.verify.VerificationWarning` and
    runs anyway; the default ``"off"`` does not import the verifier."""
    if verify not in ("off", "warn", "strict"):
        raise ValueError(
            f"verify must be one of ('off', 'warn', 'strict'), got {verify!r}")
    spec = get(spec) if isinstance(spec, str) else spec
    if verify != "off":
        from ..verify import verify_scenario_plans  # lazy: nothing imported when off

        if plan_cache is None:
            plan_cache = PlanCache()
        verify_scenario_plans(spec, plan_cache=plan_cache, mode=verify)
    return executors.get(executor).execute(spec, record_trace=record_trace,
                                           plan_cache=plan_cache)


def compare_protocols(
    topology: str,
    model_mb: float,
    n: int = 10,
    seed: int = 0,
    spec: Optional[TestbedSpec] = None,
    full_dissemination: bool = False,
    protocols: Optional[Sequence[str]] = None,
    n_segments: int = 4,
) -> Dict[str, SimResult]:
    """Run protocols on one (topology, model size) on the netsim executor:
    one single-round cell a protocol of a sweep with a ``protocol`` axis.
    The default is the paper's two columns, one exchange step a round
    (broadcast against MOSGU); ``full_dissemination`` runs flooding against
    MOSGU dissemination until every node holds every model; ``protocols``
    runs the named policies instead."""
    from .sweep import SweepSpec, run_sweep

    if protocols is not None:
        names = {p: p for p in protocols}
    elif full_dissemination:
        names = {"broadcast": "flooding", "mosgu": "dissemination"}
    else:
        names = {"broadcast": "broadcast_exchange", "mosgu": "mosgu_exchange"}
    sweep = SweepSpec(
        name=f"compare/{topology}",
        base=ScenarioSpec(
            name=f"compare/{topology}", overlay=TopologySpec(kind=topology, n=n, seed=seed),
            underlay=spec, payload=model_mb, n_segments=n_segments, rounds=1),
        grid={"protocol": tuple(names.values())})
    result = run_sweep(sweep, executor="netsim")
    return {key: cell.result.sim_results[0] for key, cell in zip(names, result.cells)}


def fedavg_check(trainer, state, batch, session=None, seed: int = 1, scale: float = 0.01
                 ) -> Tuple[Optional[bool], bool, float, Dict[str, float]]:
    """One step of ``trainer`` from unequal nodes, held to the FedAvg.

    A clone of ``state`` (left as it is) gets a seeded offset of ``scale``
    x N(0, 1) on each node's masters (and params, their cast). That clone
    takes one step on ``batch`` twice: with the gossip off (a
    ``gossip_interval`` of 2 skips step 0's round) and as ``trainer`` steps
    it, with the plan of ``session``'s membership when one is given. Every
    live node's masters after the gossip step must lie within
    :func:`check_fedavg`'s tolerance for the codec of the live nodes' FedAvg
    of the masters the gossip-off step leaves. ``state`` must be at an even
    step (a fresh one is at 0). Returns ``(numerics_ok, finite, worst
    |masters - FedAvg|, times)``: numerics_ok is None for a codec with no
    deterministic bound (top-k), whose check is finite outputs only; times
    are the gossip step's seconds by phase (``DFLTrainer``'s ``timed``
    split: fwd_bwd, optimizer, gossip)."""
    from ..dfl.trainer import DFLTrainer, TrainState

    if int(state.step) % 2:
        raise ValueError("the gossip-off step needs an even step")
    if session is not None:
        session._ensure_plan()

    def clone(s: TrainState) -> TrainState:
        return TrainState(params=tree_map(torch.clone, s.params),
                          opt_state=tree_map(torch.clone, s.opt_state), step=s.step.clone())

    mode, n = trainer.dfl.gossip_mode, trainer.n_nodes
    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    start = clone(state)
    masters = start.opt_state.get("master", start.params)
    for m, p in zip(tree_flatten(masters)[0], tree_flatten(start.params)[0]):
        m.add_(scale * torch.randn(m.shape, generator=gen, device=m.device, dtype=m.dtype))
        if p is not m:
            p.copy_(m.to(p.dtype))
    off = DFLTrainer(trainer.model, n, dataclasses.replace(trainer.dfl, gossip_interval=2),
                     device=trainer.device)
    off.plan = trainer.plan
    quiet, _ = off.train_step(clone(start), batch)
    timed, trainer.timed = trainer.timed, True
    gossiped, metrics = trainer.train_step(start, batch)
    trainer.timed = timed
    members = tuple(int(i) for i in range(n) if trainer.plan.node_slot is None
                    or trainer.plan.node_slot[i] >= 0)
    codec = trainer.codec
    ok, finite, worst = True, True, 0.0
    key = "master" if "master" in quiet.opt_state else None
    before = tree_flatten(quiet.opt_state[key] if key else quiet.params)[0]
    after = tree_flatten(gossiped.opt_state[key] if key else gossiped.params)[0]
    for w, out in zip(before, after):
        w, out = w.reshape(n, -1), out.reshape(n, -1)
        bound = 0.0 if codec is None else codec.mean_atol(float(w.abs().max()))
        leaf_ok, leaf_finite = check_fedavg(out, w, members, mode, bound, n)
        finite = finite and leaf_finite
        ok = None if leaf_ok is None else ok and leaf_ok
        mean = w[list(members)].double().mean(dim=0)
        worst = max(worst, float((out[list(members)].double() - mean).abs().max()))
    return ok, finite, worst, metrics["times"]
