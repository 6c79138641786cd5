"""Slot plans and their lowering to permutation steps (the port's copy of
``repro.core.schedule``): the compile wrappers over
:func:`~repro_torch.core.plan.compile_policy`, the matching decomposition
and the per-slot link accounting.

A slot's sends form a multicast forest; a permutation step needs distinct
sources and distinct targets, so each slot is split into matchings
(:func:`decompose_matchings`) and each matching becomes one
:class:`PermStep`. On the card a step is one gather along the node axis and
one masked write (:mod:`repro_torch.dfl.collectives`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from .graph import Graph
from .plan import (
    DisseminationPolicy,
    FloodingPolicy,
    SegmentedGossipPolicy,
    Send,
    Slot,
    SlotPlan,
    TreeAllreducePolicy,
    compile_policy,
)


def compile_dissemination(mst: Graph, colors: np.ndarray, first_color: int = 0,
                          max_slots: int = 100_000) -> SlotPlan:
    """Compile the paper's FIFO gossip into a static slot plan."""
    return compile_policy(DisseminationPolicy(mst, colors, first_color), max_slots=max_slots)


def compile_segmented(mst: Graph, colors: np.ndarray, n_segments: int = 4,
                      first_color: int = 0, max_slots: int = 100_000) -> SlotPlan:
    """Compile segmented gossip: S per-model segments gossiped independently."""
    return compile_policy(SegmentedGossipPolicy(mst, colors, segments=n_segments,
                                                first_color=first_color),
                          max_slots=max_slots)


def compile_tree_allreduce(mst: Graph, colors: np.ndarray, root: int = 0,
                           max_slots: int = 100_000) -> SlotPlan:
    """Reduce partial sums to the root, then broadcast the mean back down."""
    return compile_policy(TreeAllreducePolicy(mst, colors, root), max_slots=max_slots)


def compile_flooding(overlay: Graph, max_rounds: int = 10_000) -> SlotPlan:
    """Naive flooding, rounds-synchronous: all of a round's sends land in one
    slot (maximal link contention)."""
    return compile_policy(FloodingPolicy(overlay), max_slots=max_rounds)


def decompose_matchings(sends: Sequence[Send]) -> List[List[Send]]:
    """Split a slot's sends into matchings (unique src and unique dst each),
    greedily in send order; a forest needs max-degree matchings."""
    remaining = list(sends)
    matchings: List[List[Send]] = []
    while remaining:
        used_src: Set[int] = set()
        used_dst: Set[int] = set()
        matching: List[Send] = []
        rest: List[Send] = []
        for s in remaining:
            src, dst, _ = s
            if src not in used_src and dst not in used_dst:
                matching.append(s)
                used_src.add(src)
                used_dst.add(dst)
            else:
                rest.append(s)
        matchings.append(matching)
        remaining = rest
    return matchings


@dataclass
class PermStep:
    """One permutation step lowered from a matching.

    ``perm`` is the (src, dst) list; ``send_payload[u]`` / ``recv_payload[u]``
    give, per node, which buffer slot is read / written (-1 = idle).
    """

    perm: List[Tuple[int, int]]
    send_payload: np.ndarray  # int32[n]
    recv_payload: np.ndarray  # int32[n]


def plan_to_perm_steps(plan: SlotPlan) -> List[PermStep]:
    """Lower a compiled plan to a flat list of permutation steps."""
    steps: List[PermStep] = []
    n = plan.n
    for slot in plan.slots:
        for matching in decompose_matchings(slot.sends):
            if not matching:
                continue
            send = -np.ones(n, dtype=np.int32)
            recv = -np.ones(n, dtype=np.int32)
            perm = []
            for src, dst, payload in matching:
                perm.append((src, dst))
                send[src] = payload
                recv[dst] = payload
            steps.append(PermStep(perm=perm, send_payload=send, recv_payload=recv))
    return steps


def link_contention_profile(plan: SlotPlan) -> List[Dict[Tuple[int, int], int]]:
    """Per slot: how many transfers traverse each undirected link."""
    out = []
    for slot in plan.slots:
        usage: Dict[Tuple[int, int], int] = {}
        for src, dst, _ in slot.sends:
            key = (min(src, dst), max(src, dst))
            usage[key] = usage.get(key, 0) + 1
        out.append(usage)
    return out
