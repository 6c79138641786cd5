"""The benchmark's seeded weights, in the parameter tree both sides read.

The benchmark draws the weights itself and hands the same tree to the
program (``DFLTrainer.state_from_params``) and to the reference, so the
reference takes no weight the program made. The tree follows the layout
the port's models index (stacked layers, a leading layer axis on every
block leaf). Matrices are drawn on the generator's device in the type they
are trained in (the configuration's ``dtype``), a leaf a call; norm gains start at 0 (the port's
``1 + scale`` gain), Mamba1's ``A_log`` at ``log(1..n)``, ``D`` at 1 and
``dt_bias`` at 0. Each node starts from those weights moved by a drift of its
own (``node_params``): silos that have drifted apart, so that a gossip round
moves every node.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

VOCAB_PAD_MULTIPLE = 128  # the port pads the embedding rows to this multiple
STD = 0.02
CONV_STD = 0.5

Tree = Dict[str, Any]


def padded_vocab(vocab: int) -> int:
    return -(-vocab // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _normal(gen: torch.Generator, shape, dtype: torch.dtype, std: float = STD) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype).mul_(std)


def _zeros(gen: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=gen.device)


def dense_params(hf: Dict[str, Any], gen: torch.Generator, dt: torch.dtype) -> Tree:
    """A llama-style GQA decoder with SwiGLU and a tied head."""
    d, L = hf["hidden_size"], hf["num_hidden_layers"]
    h, kv = hf["num_attention_heads"], hf["num_key_value_heads"]
    hd, ff = d // h, hf["intermediate_size"]
    return {
        "embed": {"table": _normal(gen, (padded_vocab(hf["vocab_size"]), d), dt)},
        "final_norm": _zeros(gen, d),
        "blocks": {
            "ln1": _zeros(gen, L, d),
            "attn": {"wq": _normal(gen, (L, d, h, hd), dt), "wk": _normal(gen, (L, d, kv, hd), dt),
                     "wv": _normal(gen, (L, d, kv, hd), dt), "wo": _normal(gen, (L, h, hd, d), dt)},
            "ln2": _zeros(gen, L, d),
            "mlp": {"wg": _normal(gen, (L, d, ff), dt), "wi": _normal(gen, (L, d, ff), dt),
                    "wo": _normal(gen, (L, ff, d), dt)},
        },
    }


def mamba1_params(hf: Dict[str, Any], gen: torch.Generator, dt: torch.dtype) -> Tree:
    """An attention-free Mamba1 stack with a tied head."""
    d, L = hf["hidden_size"], hf["num_hidden_layers"]
    di, n = hf["intermediate_size"], hf["state_size"]
    r, w = hf["time_step_rank"], hf["conv_kernel"]
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=gen.device))
    return {
        "embed": {"table": _normal(gen, (padded_vocab(hf["vocab_size"]), d), dt)},
        "final_norm": _zeros(gen, d),
        "blocks": {
            "ln": _zeros(gen, L, d),
            "body": {
                "wx": _normal(gen, (L, d, di), dt), "wz": _normal(gen, (L, d, di), dt),
                "conv_w": _normal(gen, (L, w, di), dt, CONV_STD),
                "wdt_in": _normal(gen, (L, di, r), dt), "wB": _normal(gen, (L, di, n), dt),
                "wC": _normal(gen, (L, di, n), dt), "dt_proj": _normal(gen, (L, r, di), dt),
                "dt_bias": _zeros(gen, L, di),
                "A_log": a_log.expand(L, di, n).contiguous(),
                "D": torch.ones((L, di), dtype=torch.float32, device=gen.device),
                "out_proj": _normal(gen, (L, di, d), dt),
            },
        },
    }


MAKERS = {"dense": dense_params, "mamba1": mamba1_params}


def hyper(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The model's settings as the program runs them: the configuration
    file's published keys, with ``as_run`` where the port departs."""
    return {**cfg, **cfg.get("as_run", {})}


def make_params(cfg: Dict[str, Any], seed: int, device) -> Tree:
    """The configuration's weights from ``seed``, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return MAKERS[cfg["reference"]](hyper(cfg), gen, DTYPES[cfg["dtype"]])


def node_params(cfg: Dict[str, Any], drift: float, seed: int, node: int, device) -> Tree:
    """Node ``node``'s starting weights: the seed's weights with every element
    moved by normal(0, ``drift``), drawn from (seed, node), in the leaf's
    type."""
    gen = torch.Generator(device=device).manual_seed(seed * 64 + 1 + node)

    def move(t: torch.Tensor) -> torch.Tensor:
        noise = torch.randn(t.shape, generator=gen, device=gen.device, dtype=torch.float32)
        return noise.mul_(drift).add_(t.float()).to(t.dtype)

    return _map(move, make_params(cfg, seed, device))


def _map(fn, tree: Tree) -> Tree:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def flatten(tree: Tree, prefix: str = ""):
    """``[(path, leaf)]`` in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        out.extend(flatten(v, path) if isinstance(v, dict) else [(path, v)])
    return out


def count(tree: Tree) -> int:
    return sum(t.numel() for _, t in flatten(tree))
