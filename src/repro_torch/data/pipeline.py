"""Synthetic LM data pipeline with federated (non-IID) silo sharding.

The port's copy of ``repro.data.pipeline`` (numpy): the same streams, bit
for bit, from the same seed (``tests/test_torch_session.py`` holds it to
the original).

DFL's premise is that each silo holds its *own* data distribution. We model
that with a deterministic synthetic corpus: each silo samples tokens from a
Zipf-like unigram distribution whose support is rotated per silo and skewed
by a Dirichlet mixture (the standard non-IID FL benchmark construction),
plus a simple Markov bigram structure so the LM loss is learnable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    batch_per_node: int
    n_nodes: int
    dirichlet_alpha: float = 0.5  # smaller = more non-IID
    zipf_s: float = 1.2
    seed: int = 0


class SiloDataset:
    """Deterministic infinite stream of (tokens, labels) for one silo."""

    def __init__(self, cfg: DataConfig, node_id: int):
        self.cfg = cfg
        self.node_id = node_id
        rng = np.random.default_rng(cfg.seed + 7919 * node_id)
        # non-IID unigram prior: zipf base rotated per silo x dirichlet tilt
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        base = 1.0 / ranks ** cfg.zipf_s
        base = np.roll(base, (node_id * cfg.vocab) // max(cfg.n_nodes, 1))
        tilt = rng.dirichlet(np.full(16, cfg.dirichlet_alpha))
        groups = np.array_split(np.arange(cfg.vocab), 16)
        w = np.ones(cfg.vocab)
        for g, t in zip(groups, tilt):
            w[g] *= t * 16
        self.probs = base * w
        self.probs /= self.probs.sum()
        # bigram structure: next token ~ mix of unigram and (token+delta)
        self.delta = int(rng.integers(1, cfg.vocab - 1))
        self._rng = np.random.default_rng(cfg.seed + 104729 * (node_id + 1))

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        b, s = cfg.batch_per_node, cfg.seq_len
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = self._rng.choice(cfg.vocab, size=b, p=self.probs)
        unigram = self._rng.choice(cfg.vocab, size=(b, s), p=self.probs)
        use_bigram = self._rng.random((b, s)) < 0.5
        for t in range(s):
            bigram = (toks[:, t] + self.delta) % cfg.vocab
            toks[:, t + 1] = np.where(use_bigram[:, t], bigram, unigram[:, t])
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_batch()


class FederatedData:
    """All silos' streams; `global_batch(step)` stacks per-node batches along
    the batch axis in node order — matching a (nodes..., batch) sharded input."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.silos = [SiloDataset(cfg, u) for u in range(cfg.n_nodes)]

    def global_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        parts = [s.next_batch() for s in self.silos]
        tokens = np.concatenate([p[0] for p in parts], axis=0)
        labels = np.concatenate([p[1] for p in parts], axis=0)
        return tokens, labels
