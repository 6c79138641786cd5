"""Run a scenario's gossip rounds on the card (the counterpart of the JAX
package's ``jax`` scenario executor).

The plan is built once per membership epoch (churn changes it), then every
round moves the nodes' parameters along its permutation steps and checks
that each live node ends with the FedAvg mean of the live nodes, within the
codec's error bound, while masked nodes keep their own params. Byte
accounting goes through :func:`gossip_collective_bytes`.

``proxy_elems=None`` runs the payload's full f32 size per node, with random
parameters from ``seed``; ``proxy_elems=4`` reproduces the JAX executor's
``arange`` proxy field for field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import torch

from .. import DeviceLike, resolve_device
from ..dfl.collectives import GossipPlan, gossip_collective_bytes, gossip_exchange
from ..dfl.session import plan_for_members
from .spec import ScenarioSpec, get, membership_by_round, resolve_gossip_mode


@dataclass
class RoundReport:
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
    rounds: List[RoundReport] = field(default_factory=list)


def _params(spec: ScenarioSpec, elems: int, proxy: bool, seed: int,
            device: torch.device) -> torch.Tensor:
    n = spec.n
    if proxy:
        return torch.arange(n * elems, dtype=torch.float32, device=device).reshape(n, elems)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, elems), generator=gen, device=device)


def _check(out: torch.Tensor, w: torch.Tensor, members: Tuple[int, ...], mode: str,
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
                 proxy_elems: Optional[int] = None, seed: int = 0) -> ScenarioRun:
    """Run every round of a scenario; returns the per-round reports."""
    spec = get(spec_or_name) if isinstance(spec_or_name, str) else spec_or_name.validate()
    dev = resolve_device(device)
    mode = resolve_gossip_mode(spec.protocol)
    if mode == "flooding" and spec.churn:
        raise ValueError("the flooding collective (all-gather) cannot mask "
                         "churned nodes; use an MST mode for churn scenarios")
    codec = spec.codec_obj()
    overlay = spec.overlay_graph()
    elems = proxy_elems or int(round(spec.payload_mb * 1e6 / 4))
    w = _params(spec, elems, proxy_elems is not None, seed, dev)
    bound = 0.0 if codec is None else codec.mean_atol(float(w.abs().max()))
    run = ScenarioRun(spec.name, str(dev), spec.payload_mb, elems)
    epoch: Optional[Tuple[int, ...]] = None
    plan: Optional[GossipPlan] = None
    for r, members in enumerate(membership_by_round(spec)):
        if members != epoch:
            plan = plan_for_members(spec.n, members, n_segments=spec.n_segments,
                                    full_graph=overlay)
            plan.prepare(dev)  # index tensors on the card before the timed round
            epoch = members
        out, device_ms = _timed_round(mode, plan, w, codec, dev)
        numerics_ok, finite = _check(out, w, members, mode, bound, spec.n)
        del out
        slot_plan = {"dissemination": plan.dissemination, "segmented": plan.segmented,
                     "tree_allreduce": plan.tree}.get(mode)
        if slot_plan is not None:
            tx, n_slots = slot_plan.total_transmissions(), slot_plan.n_slots
        else:  # flooding: every node receives the other nodes' models
            tx, n_slots = len(members) * (len(members) - 1), 1
        run.rounds.append(RoundReport(
            round=r, members=list(members), n_slots=n_slots, transmissions=tx,
            bytes_mb=gossip_collective_bytes(mode, plan, spec.payload_mb * 1e6) / 1e6,
            bytes_on_wire_mb=gossip_collective_bytes(
                mode, plan, spec.payload_mb * 1e6, codec=codec) / 1e6,
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
