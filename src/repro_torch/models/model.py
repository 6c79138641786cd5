"""Models of the port (``repro.models.model``): ArchConfig -> init /
forward / train_loss / init_cache / decode_step, for the dense and ssm
families.

Parameters keep the JAX package's stacked-layer tree: every block leaf has
a leading layer axis (gemma2 splits ``local_blocks`` and ``global_blocks``),
so ``convert.from_numpy`` of a JAX ``Model.init`` tree is a valid params
tree here. The loops over layers are Python loops over those leaves. The
prefill forward reaches the two model kernels: flash attention in every
dense layer (``attention.attention``), the selective scan in every Mamba1
layer (``mamba.mamba1_forward``). Decode is plain PyTorch, as in the JAX
package.

``train_loss`` is differentiable: flash attention is an autograd Function
whose backward is the backward kernel on the card (its plain version on
the CPU); the selective scan has no backward kernel yet and raises on the
card when a gradient is asked of it (ROADMAP B6b). With ``cfg.remat`` each
layer of a differentiated forward runs under ``torch.utils.checkpoint``, as
``jax.checkpoint`` wraps each layer there (its forward then runs twice).

Families
  dense : llama-style GQA decoder (smollm, granite), gemma2 (alternating
          local/global layers with softcaps), and the long-context
          sliding-window variant of any dense arch (``long_500k``)
  ssm   : attention-free Mamba1 stack (falcon-mamba)
The moe, hybrid, audio and vlm families raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from . import attention as attn_lib
from . import mamba as mamba_lib
from .layers import (
    Params,
    cross_entropy_loss,
    embed,
    init_embedding,
    init_mlp,
    logits_from_embedding,
    mlp,
    rms_norm,
)

MOE_AUX_WEIGHT = 0.01

NOT_PORTED = {
    "moe": "ROADMAP Queue A item 4, the moe family (next)",
    "hybrid": "ROADMAP Queue A item 4, the hybrid family (Mamba2, after moe)",
    "audio": "ROADMAP Queue A item 4, the audio and vlm families (after hybrid)",
    "vlm": "ROADMAP Queue A item 4, the audio and vlm families (after hybrid)",
}


@dataclass
class Batch:
    tokens: torch.Tensor
    labels: Optional[torch.Tensor] = None
    encoder_frames: Optional[torch.Tensor] = None
    patch_embeddings: Optional[torch.Tensor] = None


def _layer(tree: Params, i: int) -> Params:
    """Layer i of a stacked-layer tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: List[Params]) -> Params:
    """Inverse of :func:`_layer`: per-layer trees -> one stacked tree."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


class Model:
    """Functional model; all state lives in explicit params / cache trees."""

    def __init__(self, cfg: ArchConfig, long_context: bool = False, device: DeviceLike = None):
        if cfg.family in NOT_PORTED:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet ({NOT_PORTED[cfg.family]})")
        if cfg.family not in ("dense", "ssm"):
            raise ValueError(f"unknown family {cfg.family}")
        if cfg.family == "ssm" and cfg.ssm_version != 1:
            raise NotImplementedError(f"{cfg.name}: only Mamba1 ssm stacks are ported")
        if cfg.alt_local_global and cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: alternating local/global needs an even layer count")
        self.cfg = cfg
        self.long_context = long_context
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def layer_window(self, local: bool) -> int:
        """Effective sliding window for a layer (0 = full attention)."""
        cfg = self.cfg
        if cfg.alt_local_global:
            return cfg.sliding_window if local else 0
        if self.long_context and cfg.sliding_window:
            return cfg.sliding_window  # long-context variant: all layers windowed
        return 0

    # -- init -----------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Params:
        """Random params drawn from ``gen`` on its device. Norm scales are 0,
        and Mamba1's A_log = log(1..n), D = 1, dt_bias = 0, as in the JAX
        package; the random leaves come from torch's generator, not JAX's."""
        cfg, dt = self.cfg, self.dtype
        params: Params = {"embed": init_embedding(gen, cfg.vocab, cfg.d_model, dt)}
        params["final_norm"] = self._zeros(gen, cfg.d_model)

        def dense_block() -> Params:
            return {
                "ln1": self._zeros(gen, cfg.d_model),
                "attn": attn_lib.init_attention(gen, cfg.d_model, cfg.eff_n_heads,
                                                cfg.eff_n_kv_heads, cfg.resolved_head_dim, dt),
                "ln2": self._zeros(gen, cfg.d_model),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dt),
            }

        def mamba_block() -> Params:
            return {"ln": self._zeros(gen, cfg.d_model),
                    "body": mamba_lib.init_mamba1(gen, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                                  cfg.dt_rank, cfg.conv_width, dt)}

        n = cfg.n_layers
        if cfg.family == "dense" and cfg.alt_local_global:
            params["local_blocks"] = _stack([dense_block() for _ in range(n // 2)])
            params["global_blocks"] = _stack([dense_block() for _ in range(n // 2)])
        elif cfg.family == "dense":
            params["blocks"] = _stack([dense_block() for _ in range(n)])
        else:
            params["blocks"] = _stack([mamba_block() for _ in range(n)])
        return params

    @staticmethod
    def _zeros(gen: torch.Generator, d: int) -> torch.Tensor:
        return torch.zeros((d,), dtype=torch.float32, device=gen.device)

    # -- full-sequence forward (prefill) ------------------------------------------
    def _dense_block(self, block: Params, x: torch.Tensor, positions: torch.Tensor,
                     window: int) -> torch.Tensor:
        cfg = self.cfg
        x = x + attn_lib.attention(
            block["attn"], rms_norm(x, block["ln1"]), positions, causal=True,
            sliding_window=window, softcap=cfg.attn_logit_softcap, rope_theta=cfg.rope_theta)
        return x + mlp(block["mlp"], rms_norm(x, block["ln2"]))

    def _layer_fn(self, fn):
        """``fn`` under per-layer remat when the config asks for it and
        autograd records the forward."""
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return fn
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)

    def _mamba_block(self, block: Params, x: torch.Tensor) -> torch.Tensor:
        return x + mamba_lib.mamba1_forward(block["body"], rms_norm(x, block["ln"]),
                                            self.cfg.ssm_state, self.cfg.dt_rank)

    def forward(self, params: Params, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits over the full sequence (b, s, padded vocab) f32,
        moe aux loss = 0)."""
        cfg = self.cfg
        dense_block = self._layer_fn(self._dense_block)
        mamba_block = self._layer_fn(self._mamba_block)
        tokens = batch.tokens
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        x = embed(params["embed"], tokens).to(self.dtype)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)

        if cfg.family == "dense" and cfg.alt_local_global:
            for i in range(cfg.n_layers // 2):
                x = dense_block(_layer(params["local_blocks"], i), x, positions,
                                cfg.sliding_window)
                x = dense_block(_layer(params["global_blocks"], i), x, positions, 0)
        elif cfg.family == "dense":
            window = self.layer_window(local=True) if self.long_context else 0
            for i in range(cfg.n_layers):
                x = dense_block(_layer(params["blocks"], i), x, positions, window)
        else:
            for i in range(cfg.n_layers):
                x = mamba_block(_layer(params["blocks"], i), x)

        x = rms_norm(x, params["final_norm"])
        logits = logits_from_embedding(params["embed"], x, cfg.vocab, cfg.final_logit_softcap)
        return logits, aux

    def train_loss(self, params: Params, batch: Batch) -> torch.Tensor:
        logits, aux = self.forward(params, batch)
        return cross_entropy_loss(logits, batch.labels) + MOE_AUX_WEIGHT * aux

    # -- decode: cache + one-token step ---------------------------------------------
    def init_cache(self, batch: int, cache_len: int) -> Params:
        """Zeroed decode cache on the model's device, stacked over layers."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        hd, kv = cfg.resolved_head_dim, cfg.eff_n_kv_heads

        def kvc(n_layers: int, length: int) -> Params:
            shape = (n_layers, batch, length, kv, hd)
            return {"k": torch.zeros(shape, dtype=dt, device=dev),
                    "v": torch.zeros(shape, dtype=dt, device=dev)}

        def ring(length: int) -> int:
            return min(length, cfg.sliding_window) if cfg.sliding_window else length

        if cfg.family == "dense":
            if cfg.alt_local_global:
                return {"local": kvc(cfg.n_layers // 2, ring(cache_len)),
                        "global": kvc(cfg.n_layers // 2, cache_len)}
            return {"kv": kvc(cfg.n_layers, ring(cache_len) if self.long_context else cache_len)}
        c = mamba_lib.init_mamba1_cache(batch, cfg.d_inner, cfg.ssm_state, cfg.conv_width, dt, dev)
        return {"mamba": {k: torch.zeros((cfg.n_layers, *a.shape), dtype=a.dtype, device=dev)
                          for k, a in c.items()}}

    def decode_step(self, params: Params, tokens: torch.Tensor, positions: torch.Tensor,
                    cache: Params) -> Tuple[torch.Tensor, Params]:
        """tokens: (b, 1); positions: (b,) absolute index of the new token.
        Returns (logits (b, 1, padded vocab) f32, new cache)."""
        cfg = self.cfg
        x = embed(params["embed"], tokens).to(self.dtype)

        def dense(block: Params, x: torch.Tensor, c: Params, window: int):
            h, c2 = attn_lib.decode_attention(
                block["attn"], rms_norm(x, block["ln1"]), positions, c, sliding_window=window,
                softcap=cfg.attn_logit_softcap, rope_theta=cfg.rope_theta)
            x = x + h
            return x + mlp(block["mlp"], rms_norm(x, block["ln2"])), c2

        if cfg.family == "dense" and cfg.alt_local_global:
            local, glob = [], []
            for i in range(cfg.n_layers // 2):
                x, lc = dense(_layer(params["local_blocks"], i), x, _layer(cache["local"], i),
                              cfg.sliding_window)
                x, gc = dense(_layer(params["global_blocks"], i), x, _layer(cache["global"], i), 0)
                local.append(lc)
                glob.append(gc)
            new_cache = {"local": _stack(local), "global": _stack(glob)}
        elif cfg.family == "dense":
            window = cfg.sliding_window if self.long_context else 0
            kvs = []
            for i in range(cfg.n_layers):
                x, c2 = dense(_layer(params["blocks"], i), x, _layer(cache["kv"], i), window)
                kvs.append(c2)
            new_cache = {"kv": _stack(kvs)}
        else:
            states = []
            for i in range(cfg.n_layers):
                block = _layer(params["blocks"], i)
                y, c2 = mamba_lib.mamba1_decode(block["body"], rms_norm(x, block["ln"]),
                                                _layer(cache["mamba"], i), cfg.ssm_state,
                                                cfg.dt_rank)
                x = x + y
                states.append(c2)
            new_cache = {"mamba": _stack(states)}

        x = rms_norm(x, params["final_norm"])
        logits = logits_from_embedding(params["embed"], x, cfg.vocab, cfg.final_logit_softcap)
        return logits, new_cache


def build_model(cfg: ArchConfig, shape_name: str = "", device: DeviceLike = None) -> Model:
    """Factory: the long_500k shape selects the sliding-window variant of a
    dense arch."""
    return Model(cfg, long_context=shape_name == "long_500k", device=device)
