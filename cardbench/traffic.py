"""The benchmark's one traffic generator: non-IID federated silo data.

A frozen copy of the port's ``data/pipeline.py`` (``FederatedData``), numpy
only, stream for stream: silo u draws from a Zipf(s) unigram whose support
is rotated by ``u * vocab / nodes`` and tilted by a Dirichlet(alpha) over 16
groups of the vocabulary, and half of its next tokens follow a bigram
``token + delta``. A traffic file (``cardbench/traffic/<name>.json``) gives
the sizes and the mix; the seed of a run gives the streams. Every seed draws
the same shapes: only the token ids differ.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray]


class Silo:
    """The deterministic stream of (tokens, labels) of silo ``node``."""

    def __init__(self, vocab: int, seq_len: int, rows: int, nodes: int, node: int,
                 alpha: float, zipf_s: float, seed: int):
        self.vocab, self.seq_len, self.rows = vocab, seq_len, rows
        rng = np.random.default_rng(seed + 7919 * node)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        base = np.roll(1.0 / ranks ** zipf_s, (node * vocab) // max(nodes, 1))
        tilt = rng.dirichlet(np.full(16, alpha))
        w = np.ones(vocab)
        for g, t in zip(np.array_split(np.arange(vocab), 16), tilt):
            w[g] *= t * 16
        self.probs = base * w
        self.probs /= self.probs.sum()
        self.delta = int(rng.integers(1, vocab - 1))
        self._rng = np.random.default_rng(seed + 104729 * (node + 1))

    def next_batch(self) -> Batch:
        b, s, vocab = self.rows, self.seq_len, self.vocab
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = self._rng.choice(vocab, size=b, p=self.probs)
        unigram = self._rng.choice(vocab, size=(b, s), p=self.probs)
        use_bigram = self._rng.random((b, s)) < 0.5
        for t in range(s):
            bigram = (toks[:, t] + self.delta) % vocab
            toks[:, t + 1] = np.where(use_bigram[:, t], bigram, unigram[:, t])
        return toks[:, :-1], toks[:, 1:]


def pool(vocab: int, traffic: dict, seed: int) -> List[Batch]:
    """``traffic["pool"]`` global batches, each the silos' rows stacked in
    node order: (nodes * rows_per_node, seq_len) tokens and labels."""
    n = traffic["nodes"]
    silos = [Silo(vocab, traffic["seq_len"], traffic["rows_per_node"], n, u,
                  traffic["dirichlet_alpha"], traffic["zipf_s"], seed) for u in range(n)]
    out = []
    for _ in range(traffic["pool"]):
        parts = [s.next_batch() for s in silos]
        out.append((np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])))
    return out
