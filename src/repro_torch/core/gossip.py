"""Runtime gossip engine — the slot-synchronous IR interpreter with payloads.

The port's copy of ``repro.core.gossip``. This is the *dynamic* executor of
the communication-plan IR in :mod:`repro_torch.core.plan`: the policy owns
the protocol state machine (FIFO queues, phase tracking), while the engine
moves real payload objects and supports the behaviours the static compiler
cannot express:

* transient link failures with retransmission in the node's next turn
  (paper III-D: "if the network temporarily disrupts during transmission,
  the model will be kept in F and retransmitted"),
* nodes joining/leaving between rounds (handled upstream by the moderator,
  which recompiles MST/colors),
* arbitrary payloads (tensors on any device, pytrees of them, byte strings).

Both the engine and the compiled plans interpret the *same* policy, so
without failures they agree slot for slot. With a codec the payloads cross
the wire encoded (:meth:`~repro_torch.compress.Codec.encode_payload`): a
CUDA payload through the quantize / dequantize / top-k kernels, and
:func:`fedavg` averages on the card through the ``gossip_mix`` kernel.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from .. import obs
from ..compress.codec import Codec, EncodedPayload, tree_map
from ..kernels.mixing.ops import fedavg_mean
from .graph import Graph
from .plan import CommPolicy, DisseminationPolicy, Send


@dataclass
class QueueEntry:
    owner: int  # payload id (model owner; owner*S+seg for segmented gossip)
    round_idx: int
    payload: Any = None
    predecessor: int = -1  # node we received it from; -1 = locally produced


@dataclass
class GossipNode:
    """One DFL participant's view: id, neighbours, and received payloads."""

    node_id: int
    neighbors: List[int]
    received: Dict[int, QueueEntry] = field(default_factory=dict)

    @property
    def degree(self) -> int:
        return len(self.neighbors)


@dataclass
class SlotReport:
    slot_idx: int
    color: int
    sends: List[Send]  # (src, dst, payload_id)
    dropped: List[Send]  # failed transfers (kept in F)


class GossipEngine:
    """Slot-synchronous runtime executor of a communication policy.

    By default runs the paper's MOSGU dissemination over an MST; pass any
    slot policy from :mod:`repro_torch.core.plan` (segmented gossip, tree
    all-reduce, flooding) to execute it with live payloads instead.

    ``drop_fn(slot_idx, src, dst)`` may return True to simulate a transient
    link failure; the policy then keeps the entry at the *head* of the
    sender's FIFO and it is retransmitted on the node's next active slot.

    ``codec`` (a :class:`repro_torch.compress.Codec`) puts the wire format in
    the loop: each node's round payloads are *encoded* at ``begin_round`` (with
    per-payload error-feedback residuals that persist across rounds — what
    top-k drops this round is compensated next round), the queues move
    :class:`EncodedPayload` objects whose exact ``bytes_on_wire`` are tallied
    per round (``round_wire_bytes``), and :meth:`aggregate` decodes before
    combining (FedAvg sees what actually crossed the network).
    """

    def __init__(
        self,
        mst: Optional[Graph] = None,
        colors: Optional[np.ndarray] = None,
        first_color: int = 0,
        drop_fn: Optional[Callable[[int, int, int], bool]] = None,
        policy: Optional[CommPolicy] = None,
        codec: Optional[Codec] = None,
    ) -> None:
        if policy is None:
            if mst is None or colors is None:
                raise ValueError("need either a policy or (mst, colors)")
            policy = DisseminationPolicy(mst, colors, first_color)
        self.policy = policy
        self.mst = policy.graph if policy.graph is not None else mst
        self.colors = policy.colors
        self.drop_fn = drop_fn
        graph = self.mst
        self.nodes = [
            GossipNode(u, graph.neighbors(u) if graph is not None else [])
            for u in range(policy.n)
        ]
        self.slot_idx = 0
        self.reports: List[SlotReport] = []
        self._store: Dict[int, Any] = {}
        self._round_idx = 0
        self.codec = codec
        # per-payload-id error-feedback residuals; persist across rounds
        self._ef_states: Dict[int, Any] = {}
        self.round_wire_bytes = 0

    @property
    def n(self) -> int:
        return self.policy.n

    # -- round lifecycle ----------------------------------------------------
    def begin_round(self, round_idx: int, payloads: Optional[Sequence[Any]] = None) -> None:
        self.policy.reset()
        self._round_idx = round_idx
        self._store = {}
        self.round_wire_bytes = 0
        for node in self.nodes:
            node.received.clear()
        for u, node in enumerate(self.nodes):
            pids = self.policy.initial_payload_ids(u)
            if payloads is not None and pids:
                if len(pids) == 1:
                    self._store[pids[0]] = self._encode(pids[0], payloads[u])
                else:
                    parts = payloads[u]
                    if not isinstance(parts, (list, tuple)) or len(parts) != len(pids):
                        raise ValueError(
                            f"node {u}: segmented policies need one payload per "
                            f"segment ({len(pids)} expected)")
                    for pid, part in zip(pids, parts):
                        self._store[pid] = self._encode(pid, part)
            for pid in pids:
                node.received[pid] = QueueEntry(pid, round_idx, self._store.get(pid), -1)

    def _encode(self, pid: int, payload: Any) -> Any:
        """Encode a node's own payload for the wire, carrying the payload's
        error-feedback residual from the previous round."""
        if self.codec is None or payload is None:
            return payload
        state = self._ef_states.get(pid, self.codec.init_state())
        encoded, self._ef_states[pid] = self.codec.encode_payload(payload, state)
        return encoded

    def _decode(self, payload: Any) -> Any:
        if self.codec is not None and isinstance(payload, EncodedPayload):
            return self.codec.decode_payload(payload)
        return payload

    def step(self) -> SlotReport:
        """Advance one colored slot."""
        sends = self.policy.emit(self.slot_idx)
        tuples = sends.tuples()
        ok = np.ones(len(tuples), dtype=bool)
        report = SlotReport(self.slot_idx, sends.color, [], [])
        for i, (src, dst, pid) in enumerate(tuples):
            if self.drop_fn is not None and self.drop_fn(self.slot_idx, src, dst):
                ok[i] = False
                report.dropped.append((src, dst, pid))
            else:
                report.sends.append((src, dst, pid))
            stored = self._store.get(pid)
            if isinstance(stored, EncodedPayload):  # dropped sends burn wire too
                self.round_wire_bytes += stored.bytes_on_wire
        delivered = self.policy.commit(self.slot_idx, sends, ok)
        for src, dst, pid in zip(delivered.src.tolist(), delivered.dst.tolist(),
                                 delivered.payload.tolist()):
            self.nodes[dst].received[pid] = QueueEntry(
                pid, self._round_idx, self._store.get(pid), src)
        self.slot_idx += 1
        self.reports.append(report)
        return report

    def run_round(
        self, round_idx: int, payloads: Optional[Sequence[Any]] = None, max_slots: int = 100_000
    ) -> int:
        """Run slots until the policy completes; return number of slots used."""
        self.begin_round(round_idx, payloads)
        start = self.slot_idx
        rec = obs.get()
        while not self.is_round_complete():
            if self.slot_idx - start >= max_slots:
                raise RuntimeError("gossip round did not converge")
            if rec.enabled:
                wire0 = self.round_wire_bytes
                with rec.span(f"slot {self.slot_idx}", cat="engine-slot",
                              track="engine", round=round_idx):
                    report = self.step()
                rec.count("engine.slot_sends", len(report.sends))
                if report.dropped:
                    rec.count("engine.slot_drops", len(report.dropped))
                rec.count("engine.slot_wire_bytes",
                          self.round_wire_bytes - wire0)
            else:
                self.step()
        return self.slot_idx - start

    def is_round_complete(self) -> bool:
        return self.policy.done()

    # -- inspection ---------------------------------------------------------
    def queue_snapshot(self) -> List[List[int]]:
        return self.policy.queue_snapshot()

    def received_snapshot(self) -> List[Set[int]]:
        return [set(nd.received.keys()) for nd in self.nodes]

    def aggregate(self, combine: Callable[[List[Any]], Any]) -> List[Any]:
        """Per-node aggregation over all received payloads (e.g. FedAvg).

        For segmented policies each node returns a list of S per-segment
        aggregates (segment j combines every owner's j-th segment), which
        concatenate back into the aggregated model. Codec-encoded payloads
        are decoded first: FedAvg averages what crossed the network, not the
        senders' local tensors.
        """
        S = getattr(self.policy, "segments", 1)
        out: List[Any] = []
        for nd in self.nodes:
            if S == 1:
                out.append(combine([self._decode(nd.received[o].payload)
                                    for o in sorted(nd.received)]))
            else:
                out.append([
                    combine([self._decode(nd.received[pid].payload)
                             for pid in sorted(nd.received) if pid % S == j])
                    for j in range(S)
                ])
        return out


def fedavg(payloads: List[Any]) -> Any:
    """Uniform FedAvg over pytrees of tensors (nested dict / list / tuple),
    in place of the reference's ``fedavg_numpy``: each leaf's n copies are
    stacked to ``(1, n, numel)`` f32 and averaged by
    :func:`~repro_torch.kernels.mixing.ops.fedavg_mean` (on the card the
    ``gossip_mix`` kernel, on the CPU its plain version); each result takes
    its leaf's shape."""
    def avg(*xs):
        x0 = torch.as_tensor(xs[0])
        rows = [torch.as_tensor(x).to(torch.float32).reshape(-1) for x in xs]
        return fedavg_mean(torch.stack(rows).unsqueeze(0))[0].reshape(x0.shape)

    return tree_map(avg, *payloads)
