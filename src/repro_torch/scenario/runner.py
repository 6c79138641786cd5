"""Run a scenario's gossip rounds on the card (the counterpart of the JAX
package's ``jax`` scenario executor).

Each round's members, slots, transmissions and bytes are the counting
executor's (:class:`~repro_torch.scenario.executors.PlanExecutor`: the
moderator lifecycle over the overlay, the protocol's policy), run with the
same :class:`~repro_torch.scenario.cache.PlanCache` whose effective overlay
the device plans over: the declared graph, or the annealed working overlay
when the spec declares an optimizer (as the reference's jax executor plans
over its executor's ``overlay``). The exception is
flooding: the device runs it as an all-gather, where every live node
receives the other live nodes' models in one slot, as the JAX package's
``jax`` executor counts it, while the plan executor counts a relay flood
over the overlay's edges. The device plan is built once per membership
epoch (churn changes it), then every round moves the nodes' parameters
along its permutation steps and checks that each live node ends with the
FedAvg mean of the live nodes, within the codec's error bound, while masked
nodes keep their own params.

``proxy_elems=None`` runs the payload's full f32 size per node, with random
parameters from ``seed``; ``proxy_elems=4`` reproduces the JAX executor's
``arange`` proxy field for field.

:func:`compare_protocols` is the reference runner's function of that name
(the paper's two-column tables on the fluid simulator), which
``repro_torch.core.netsim.compare_protocols`` delegates to.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from .. import DeviceLike, resolve_device
from ..compress.codec import per_send_wire_mb
from ..core.graph import TopologySpec
from ..core.netsim import SimResult, TestbedSpec
from ..dfl.collectives import GossipPlan, gossip_exchange, tree_flatten, tree_map
from ..dfl.session import plan_for_members
from .cache import PlanCache
from .executors import PlanExecutor
from .registry import get
from .spec import ScenarioSpec, resolve_gossip_mode


@dataclass
class DeviceRoundReport:
    round: int
    members: List[int]
    n_slots: int
    transmissions: int
    bytes_mb: float
    bytes_on_wire_mb: float
    numerics_ok: Optional[bool]  # None: the codec has no deterministic bound
    finite: bool  # every output finite, in the input's shape
    device_ms: Optional[float]  # the round on the card (CUDA events); None on CPU

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclass
class ScenarioRun:
    scenario: str
    device: str
    payload_mb: float
    elems_per_node: int
    rounds: List[DeviceRoundReport] = field(default_factory=list)
    # each membership epoch's device plan (MST, colors, permutation steps)
    plans: List[GossipPlan] = field(default_factory=list, repr=False)


def _params(spec: ScenarioSpec, elems: int, proxy: bool, seed: int,
            device: torch.device) -> torch.Tensor:
    n = spec.n
    if proxy:
        return torch.arange(n * elems, dtype=torch.float32, device=device).reshape(n, elems)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, elems), generator=gen, device=device)


def check_fedavg(out: torch.Tensor, w: torch.Tensor, members: Tuple[int, ...], mode: str,
           bound: Optional[float], n: int) -> Tuple[Optional[bool], bool]:
    """(numerics_ok, finite), with the JAX executor's rule: live nodes within
    ``max(1e-5, bound·(1 or n))`` (+ rtol 1e-5) of the live nodes' f64 mean,
    masked nodes unchanged within 1e-6."""
    finite = out.shape == w.shape and bool(torch.isfinite(out).all())
    if bound is None:
        return None, finite
    mean = torch.zeros(w.shape[1], dtype=torch.float64, device=w.device)
    for m in members:
        mean += w[m].double()
    mean /= len(members)
    atol = max(1e-5, bound * (1 if mode == "dissemination" else n))
    ok = all(torch.allclose(out[m].double(), mean, rtol=1e-5, atol=atol)
             for m in members)
    if mode != "flooding":
        for m in sorted(set(range(n)) - set(members)):
            ok = ok and torch.allclose(out[m], w[m], rtol=1e-5, atol=1e-6)
    return ok, finite


def run_scenario(spec_or_name: Union[str, ScenarioSpec], device: DeviceLike = None,
                 proxy_elems: Optional[int] = None, seed: int = 0,
                 plan_cache: Optional[PlanCache] = None, verify: str = "off") -> ScenarioRun:
    """Run every round of a scenario; returns the per-round reports.
    ``plan_cache`` shares the overlay, its search and the plans with other
    runs (a fresh cache when omitted).

    ``verify`` statically proves every epoch's plan on the run's cache
    before the first device round (:mod:`repro_torch.verify`):
    ``"strict"`` raises :class:`~repro_torch.verify.VerificationError` on
    the first violated invariant, so a violating plan never reaches the
    card; ``"warn"`` downgrades it to a
    :class:`~repro_torch.verify.VerificationWarning` and runs anyway; the
    default ``"off"`` does not import the verifier."""
    if verify not in ("off", "warn", "strict"):
        raise ValueError(
            f"verify must be one of ('off', 'warn', 'strict'), got {verify!r}")
    spec = get(spec_or_name) if isinstance(spec_or_name, str) else spec_or_name.validate()
    dev = resolve_device(device)
    mode = resolve_gossip_mode(spec.protocol)
    if mode == "flooding" and spec.churn:
        raise ValueError("the flooding collective (all-gather) cannot mask "
                         "churned nodes; use an MST mode for churn scenarios")
    codec = spec.codec_obj()
    cache = plan_cache if plan_cache is not None else PlanCache()
    if verify != "off":
        from ..verify import verify_scenario_plans  # lazy: nothing imported when off

        verify_scenario_plans(spec, plan_cache=cache, mode=verify)
    overlay = cache.overlay(spec)
    payload_mb = spec.payload_mb()
    elems = proxy_elems or int(round(payload_mb * 1e6 / 4))
    w = _params(spec, elems, proxy_elems is not None, seed, dev)
    bound = 0.0 if codec is None else codec.mean_atol(float(w.abs().max()))
    run = ScenarioRun(spec.name, str(dev), payload_mb, elems)
    epoch: Optional[Tuple[int, ...]] = None
    plan: Optional[GossipPlan] = None
    for counted in PlanExecutor().execute(spec, plan_cache=cache).rounds:
        members = tuple(counted.members)
        if members != epoch:
            plan = plan_for_members(spec.n, members, n_segments=spec.n_segments,
                                    full_graph=overlay)
            plan.prepare(dev)  # index tensors on the card before the timed round
            run.plans.append(plan)
            epoch = members
        out, device_ms = _timed_round(mode, plan, w, codec, dev)
        numerics_ok, finite = check_fedavg(out, w, members, mode, bound, spec.n)
        del out
        n_slots, tx = counted.n_slots, counted.transmissions
        bytes_mb, wire_mb = counted.bytes_mb, counted.bytes_on_wire_mb
        if mode == "flooding":  # the all-gather: each live node receives the others' models
            n_slots, tx = 1, len(members) * (len(members) - 1)
            bytes_mb, wire_mb = tx * payload_mb, tx * per_send_wire_mb(codec, payload_mb)
        run.rounds.append(DeviceRoundReport(
            round=counted.round, members=list(members), n_slots=n_slots, transmissions=tx,
            bytes_mb=bytes_mb, bytes_on_wire_mb=wire_mb,
            numerics_ok=numerics_ok, finite=finite, device_ms=device_ms))
    return run


def _timed_round(mode: str, plan: GossipPlan, w: torch.Tensor, codec,
                 dev: torch.device) -> Tuple[torch.Tensor, Optional[float]]:
    if dev.type != "cuda":
        return gossip_exchange(mode, plan, {"w": w}, codec=codec)["w"], None
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = gossip_exchange(mode, plan, {"w": w}, codec=codec)["w"]
    end.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(end)


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
