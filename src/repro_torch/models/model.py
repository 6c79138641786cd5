"""Models of the port (``repro.models.model``): ArchConfig -> init /
forward / train_loss / init_cache / decode_step, for every family of the JAX
package's.

Parameters keep the JAX package's stacked-layer tree: every block leaf has
a leading layer axis (gemma2 splits ``local_blocks`` and ``global_blocks``;
the hybrid stacks ``mamba_blocks`` over (super-block, block) and keeps one
``shared_attn`` block), so ``convert.from_numpy`` of a JAX ``Model.init``
tree is a valid params tree here. ``init`` fills each stacked leaf in place,
layer by layer, so it never holds the per-layer trees and their stacked copy
at once. The loops
over layers are Python loops over those leaves. The prefill forward reaches
the two model kernels: flash attention in every dense and moe layer, in
each use of the hybrid's shared attention block, in whisper's encoder
layers and in both attentions of its decoder layers, and twice in each
paligemma layer with patches (the prefix split, ``attention.attention``);
the selective scan in every Mamba1 layer (``mamba.mamba1_forward``); the
hybrid's Mamba2 blocks are plain PyTorch (``mamba.ssd_scan``), as the JAX
package's are jnp. Decode is plain PyTorch, as in the JAX package, except
whisper's cross-attention of the one token against the encoder's keys,
which is a flash call like any other cross-attention.

``train_loss`` is differentiable: flash attention and the selective scan
are autograd Functions whose backwards are the backward kernels on the card
(their plain versions on the CPU). With ``cfg.remat`` each
layer of a differentiated forward runs under ``torch.utils.checkpoint``, as
``jax.checkpoint`` wraps each layer there (its forward then runs twice).

Families
  dense : llama-style GQA decoder (smollm, granite), gemma2 (alternating
          local/global layers with softcaps), and the long-context
          sliding-window variant of any dense arch (``long_500k``)
  moe   : dense attention + top-k expert MLP (qwen3-moe; arctic adds a dense
          residual MLP), ``models/moe.py``; the forward's aux loss is the
          layers' Switch losses averaged over layers
  ssm   : attention-free Mamba1 stack (falcon-mamba)
  hybrid: Mamba2 blocks with one shared attention block every ``attn_every``
          layers (zamba2): ``n_layers // attn_every`` super-blocks of
          ``attn_every - 1`` Mamba2 blocks and the shared block, then the
          remaining Mamba2 blocks as a tail. The shared block is one set of
          tensors used by every super-block, so autograd sums its gradient
          over the uses, as XLA does
  audio : whisper's encoder-decoder backbone. The frontend is a stub, as in
          the JAX package: the batch carries precomputed ``encoder_frames``
          (b, n_frames, d). Encoder layers are dense blocks with
          bidirectional self-attention (rope over the frames), then
          ``enc_final_norm``; each decoder layer is causal self-attention,
          cross-attention to the encoder output (K and V projected from it,
          no rope), then the MLP; no logit softcap. The decode cache adds
          ``cross_k`` and ``cross_v`` (n_layers, b, n_frames, kv, hd), which
          a decode step reads and passes through; nothing in the package
          fills them (the reference CLI neither, ROADMAP R10)
  vlm   : paligemma, the dense decoder over ``[patch_embeddings; tokens]``
          (the SigLIP encoder a stub, as in the JAX package): the patches
          attend bidirectionally among themselves (``prefix_len``), the text
          causally, and the logits cover the text positions only. Decode is
          the dense decode, with no prefix
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import DeviceLike, resolve_device
from ..configs.base import ArchConfig
from . import attention as attn_lib
from . import mamba as mamba_lib
from .moe import MoEStats, init_moe, moe_layer
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


def _tree_map(fn, tree: Params, *rest: Params) -> Params:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _stack_layers(n: int, make_block: Callable[[], Params]) -> Params:
    """The stacked tree of ``n`` blocks from ``make_block()``, drawn in layer
    order (the draws of ``_stack([make_block() for _ in range(n)])``) and
    copied into each stacked leaf in place: at most the stacked tree and one
    layer's tree live at once. One layer is a view of its own tree."""
    first = make_block()
    if n == 1:
        return _tree_map(lambda t: t.unsqueeze(0), first)
    out = _tree_map(lambda t: t.new_empty((n, *t.shape)), first)
    _tree_map(lambda o, t: o[0].copy_(t), out, first)
    del first
    for i in range(1, n):
        _tree_map(lambda o, t: o[i].copy_(t), out, make_block())
    return out


class Model:
    """Functional model; all state lives in explicit params / cache trees."""

    def __init__(self, cfg: ArchConfig, long_context: bool = False, device: DeviceLike = None):
        if cfg.family not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"):
            raise ValueError(f"unknown family {cfg.family}")
        if cfg.family == "ssm" and cfg.ssm_version != 1:
            raise NotImplementedError(f"{cfg.name}: only Mamba1 ssm stacks are ported")
        if cfg.family == "hybrid":
            if cfg.ssm_version != 2 or not 2 <= cfg.attn_every <= cfg.n_layers:
                raise ValueError(f"{cfg.name}: a hybrid stack takes Mamba2 blocks and an "
                                 "attention block every attn_every layers, 2 <= attn_every "
                                 "<= n_layers")
            self.n_super = cfg.n_layers // cfg.attn_every
            self.mamba_per_super = cfg.attn_every - 1
            self.n_tail = cfg.n_layers - self.n_super * cfg.attn_every
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
        Mamba1's A_log = log(1..n) and Mamba2's 0, D = 1, dt_bias = 0, as in
        the JAX package; the random leaves come from torch's generator, not
        JAX's.
        Peak memory: the stacked tree, one layer's tree and one leaf's f32
        draw (:func:`_stack_layers`)."""
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

        def moe_block() -> Params:
            return {
                "ln1": self._zeros(gen, cfg.d_model),
                "attn": attn_lib.init_attention(gen, cfg.d_model, cfg.eff_n_heads,
                                                cfg.eff_n_kv_heads, cfg.resolved_head_dim, dt),
                "ln2": self._zeros(gen, cfg.d_model),
                "moe": init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, dt,
                                cfg.dense_ff if cfg.moe_dense_residual else 0),
            }

        def mamba_block() -> Params:
            return {"ln": self._zeros(gen, cfg.d_model),
                    "body": mamba_lib.init_mamba1(gen, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                                  cfg.dt_rank, cfg.conv_width, dt)}

        def mamba2_block() -> Params:
            return {"ln": self._zeros(gen, cfg.d_model),
                    "body": mamba_lib.init_mamba2(gen, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                                                  cfg.conv_width, dt)}

        def decoder_block() -> Params:
            return {
                "ln1": self._zeros(gen, cfg.d_model),
                "attn": attn_lib.init_attention(gen, cfg.d_model, cfg.eff_n_heads,
                                                cfg.eff_n_kv_heads, cfg.resolved_head_dim, dt),
                "ln_cross": self._zeros(gen, cfg.d_model),
                "cross": attn_lib.init_attention(gen, cfg.d_model, cfg.eff_n_heads,
                                                 cfg.eff_n_kv_heads, cfg.resolved_head_dim, dt),
                "ln2": self._zeros(gen, cfg.d_model),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dt),
            }

        n = cfg.n_layers
        if cfg.family in ("dense", "vlm") and cfg.alt_local_global:
            params["local_blocks"] = _stack_layers(n // 2, dense_block)
            params["global_blocks"] = _stack_layers(n // 2, dense_block)
        elif cfg.family in ("dense", "vlm"):
            params["blocks"] = _stack_layers(n, dense_block)
        elif cfg.family == "moe":
            params["blocks"] = _stack_layers(n, moe_block)
        elif cfg.family == "hybrid":
            n_super, per = self.n_super, self.mamba_per_super
            params["mamba_blocks"] = _tree_map(
                lambda t: t.reshape(n_super, per, *t.shape[1:]),
                _stack_layers(n_super * per, mamba2_block))
            params["shared_attn"] = dense_block()
            if self.n_tail:
                params["tail_blocks"] = _stack_layers(self.n_tail, mamba2_block)
        elif cfg.family == "audio":
            params["enc_blocks"] = _stack_layers(cfg.n_encoder_layers, dense_block)
            params["enc_final_norm"] = self._zeros(gen, cfg.d_model)
            params["blocks"] = _stack_layers(n, decoder_block)
        else:
            params["blocks"] = _stack_layers(n, mamba_block)
        return params

    @staticmethod
    def _zeros(gen: torch.Generator, d: int) -> torch.Tensor:
        return torch.zeros((d,), dtype=torch.float32, device=gen.device)

    # -- full-sequence forward (prefill) ------------------------------------------
    def _dense_block(self, block: Params, x: torch.Tensor, positions: torch.Tensor,
                     window: int, prefix_len: int = 0) -> torch.Tensor:
        cfg = self.cfg
        x = x + attn_lib.attention(
            block["attn"], rms_norm(x, block["ln1"]), positions, causal=True,
            sliding_window=window, softcap=cfg.attn_logit_softcap, rope_theta=cfg.rope_theta,
            prefix_len=prefix_len)
        return x + mlp(block["mlp"], rms_norm(x, block["ln2"]))

    def _encoder_block(self, block: Params, x: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
        """A whisper encoder layer: bidirectional self-attention over the
        frames (rope, no softcap, as the JAX package's), then the MLP."""
        x = x + attn_lib.attention(block["attn"], rms_norm(x, block["ln1"]), positions,
                                   causal=False, rope_theta=self.cfg.rope_theta)
        return x + mlp(block["mlp"], rms_norm(x, block["ln2"]))

    def _decoder_block(self, block: Params, x: torch.Tensor, positions: torch.Tensor,
                       enc: torch.Tensor) -> torch.Tensor:
        """A whisper decoder layer: causal self-attention, cross-attention to
        the encoder output ``enc`` (K and V projected from it, no rope, every
        frame visible), then the MLP."""
        x = x + attn_lib.attention(block["attn"], rms_norm(x, block["ln1"]), positions,
                                   causal=True, rope_theta=self.cfg.rope_theta)
        cross = block["cross"]
        kv = (attn_lib.project_heads(enc, cross["wk"]), attn_lib.project_heads(enc, cross["wv"]))
        x = x + attn_lib.attention(cross, rms_norm(x, block["ln_cross"]), positions,
                                   causal=False, use_rope=False, kv_override=kv,
                                   kv_positions=None)
        return x + mlp(block["mlp"], rms_norm(x, block["ln2"]))

    def encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """whisper's encoder: (b, n_frames, d) frames -> the normed encoder
        output in the model's dtype."""
        encoder_block = self._layer_fn(self._encoder_block)
        x = frames.to(self.dtype)
        b, f, _ = x.shape
        positions = torch.arange(f, device=x.device).expand(b, f)
        for i in range(self.cfg.n_encoder_layers):
            x = encoder_block(_layer(params["enc_blocks"], i), x, positions)
        return rms_norm(x, params["enc_final_norm"])

    def _layer_fn(self, fn):
        """``fn`` under per-layer remat when the config asks for it and
        autograd records the forward."""
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return fn
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)

    def _mamba_block(self, block: Params, x: torch.Tensor) -> torch.Tensor:
        return x + mamba_lib.mamba1_forward(block["body"], rms_norm(x, block["ln"]),
                                            self.cfg.ssm_state, self.cfg.dt_rank)

    def _mamba2_block(self, block: Params, x: torch.Tensor) -> torch.Tensor:
        return x + mamba_lib.mamba2_forward(block["body"], rms_norm(x, block["ln"]),
                                            self.cfg.ssm_state)

    def _super_block(self, mamba_blocks: Params, shared: Params, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
        """One hybrid super-block: its Mamba2 blocks, then the shared
        attention block (full causal attention, as the JAX package's)."""
        for j in range(self.mamba_per_super):
            x = self._mamba2_block(_layer(mamba_blocks, j), x)
        return self._dense_block(shared, x, positions, 0)

    def _moe_block(self, block: Params, x: torch.Tensor, positions: torch.Tensor,
                   window: int) -> Tuple[torch.Tensor, torch.Tensor, MoEStats]:
        cfg = self.cfg
        x = x + attn_lib.attention(
            block["attn"], rms_norm(x, block["ln1"]), positions, causal=True,
            sliding_window=window, softcap=cfg.attn_logit_softcap, rope_theta=cfg.rope_theta)
        y, aux, stats = moe_layer(block["moe"], rms_norm(x, block["ln2"]), cfg.top_k,
                                  cfg.moe_capacity_factor)
        return x + y, aux, stats

    def _moe_layers(self, params: Params, x: torch.Tensor, positions: torch.Tensor,
                    stats: Optional[List[MoEStats]]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The moe stack: (x, the layers' aux losses summed), each layer's
        :class:`MoEStats` appended to ``stats`` when given."""
        moe_block = self._layer_fn(self._moe_block)
        window = self.cfg.sliding_window if self.long_context else 0
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self.cfg.n_layers):
            x, a, st = moe_block(_layer(params["blocks"], i), x, positions, window)
            aux = aux + a
            if stats is not None:
                stats.append(st)
        return x, aux

    def forward(self, params: Params, batch: Batch,
                stats: Optional[List[MoEStats]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits over the full sequence (b, s, padded vocab) f32,
        moe aux loss: the layers' mean, 0 outside the moe family). A moe
        forward appends each layer's :class:`MoEStats` to ``stats`` when
        given."""
        cfg = self.cfg
        dense_block = self._layer_fn(self._dense_block)
        mamba_block = self._layer_fn(self._mamba_block)
        tokens = batch.tokens
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        if cfg.family == "audio":
            return self._forward_encdec(params, batch), aux
        x = embed(params["embed"], tokens).to(self.dtype)
        prefix_len = 0
        if cfg.family == "vlm" and batch.patch_embeddings is not None:
            x = torch.cat([batch.patch_embeddings.to(self.dtype), x], dim=1)
            prefix_len = batch.patch_embeddings.shape[1]
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)

        if cfg.family == "moe":
            x, aux = self._moe_layers(params, x, positions, stats)
            aux = aux / cfg.n_layers
        elif cfg.family in ("dense", "vlm") and cfg.alt_local_global:
            for i in range(cfg.n_layers // 2):
                x = dense_block(_layer(params["local_blocks"], i), x, positions,
                                cfg.sliding_window)
                x = dense_block(_layer(params["global_blocks"], i), x, positions, 0)
        elif cfg.family in ("dense", "vlm"):
            window = self.layer_window(local=True) if self.long_context else 0
            for i in range(cfg.n_layers):
                x = dense_block(_layer(params["blocks"], i), x, positions, window, prefix_len)
        elif cfg.family == "hybrid":
            super_block = self._layer_fn(self._super_block)
            mamba2_block = self._layer_fn(self._mamba2_block)
            for i in range(self.n_super):
                x = super_block(_layer(params["mamba_blocks"], i), params["shared_attn"], x,
                                positions)
            for i in range(self.n_tail):
                x = mamba2_block(_layer(params["tail_blocks"], i), x)
        else:
            for i in range(cfg.n_layers):
                x = mamba_block(_layer(params["blocks"], i), x)

        # the logits of the text positions only (vlm); each row is normed and
        # projected on its own, so the prefix rows are dropped before the head
        x = rms_norm(x[:, prefix_len:], params["final_norm"])
        logits = logits_from_embedding(params["embed"], x, cfg.vocab, cfg.final_logit_softcap)
        return logits, aux

    def _forward_encdec(self, params: Params, batch: Batch) -> torch.Tensor:
        """whisper: the encoder over ``batch.encoder_frames``, then the
        decoder over the tokens; logits (b, s, padded vocab) f32, no softcap."""
        enc = self.encode(params, batch.encoder_frames)
        decoder_block = self._layer_fn(self._decoder_block)
        x = embed(params["embed"], batch.tokens).to(self.dtype)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        for i in range(self.cfg.n_layers):
            x = decoder_block(_layer(params["blocks"], i), x, positions, enc)
        x = rms_norm(x, params["final_norm"])
        return logits_from_embedding(params["embed"], x, self.cfg.vocab)

    def train_loss(self, params: Params, batch: Batch) -> torch.Tensor:
        logits, aux = self.forward(params, batch)
        return cross_entropy_loss(logits, batch.labels) + MOE_AUX_WEIGHT * aux

    @torch.no_grad()
    def route_counts(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """(n_layers, n_experts) f32: each moe layer's f counts
        (:attr:`MoEStats.f`) over ``tokens``, from the layers alone (no
        logits) and without a graph; the forward computes them the same
        way, launch for launch."""
        if self.cfg.family != "moe":
            raise ValueError(f"{self.cfg.name}: route_counts needs a moe model")
        x = embed(params["embed"], tokens).to(self.dtype)
        b, s, _ = x.shape
        stats: List[MoEStats] = []
        self._moe_layers(params, x, torch.arange(s, device=x.device).expand(b, s), stats)
        return torch.stack([st.f for st in stats])

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

        if cfg.family in ("dense", "moe", "vlm"):
            if cfg.alt_local_global:
                return {"local": kvc(cfg.n_layers // 2, ring(cache_len)),
                        "global": kvc(cfg.n_layers // 2, cache_len)}
            return {"kv": kvc(cfg.n_layers, ring(cache_len) if self.long_context else cache_len)}
        if cfg.family == "audio":
            cross = (cfg.n_layers, batch, cfg.n_frames, kv, hd)
            return {"kv": kvc(cfg.n_layers, cache_len),
                    "cross_k": torch.zeros(cross, dtype=dt, device=dev),
                    "cross_v": torch.zeros(cross, dtype=dt, device=dev)}

        def stacked(c: Params, *lead: int) -> Params:
            return {k: torch.zeros((*lead, *a.shape), dtype=a.dtype, device=dev)
                    for k, a in c.items()}

        if cfg.family == "hybrid":  # the shared block keeps a cache for each of its uses
            c = mamba_lib.init_mamba2_cache(batch, cfg.d_inner, cfg.ssm_state, cfg.conv_width,
                                            dt, dev)
            out = {"mamba": stacked(c, self.n_super, self.mamba_per_super),
                   "attn": kvc(self.n_super, cache_len)}
            if self.n_tail:
                out["tail"] = stacked(c, self.n_tail)
            return out
        c = mamba_lib.init_mamba1_cache(batch, cfg.d_inner, cfg.ssm_state, cfg.conv_width, dt, dev)
        return {"mamba": stacked(c, cfg.n_layers)}

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
            if cfg.family == "moe":  # the aux loss is not needed here
                y, _, _ = moe_layer(block["moe"], rms_norm(x, block["ln2"]), cfg.top_k,
                                    cfg.moe_capacity_factor)
                return x + y, c2
            return x + mlp(block["mlp"], rms_norm(x, block["ln2"])), c2

        if cfg.family in ("dense", "vlm") and cfg.alt_local_global:
            local, glob = [], []
            for i in range(cfg.n_layers // 2):
                x, lc = dense(_layer(params["local_blocks"], i), x, _layer(cache["local"], i),
                              cfg.sliding_window)
                x, gc = dense(_layer(params["global_blocks"], i), x, _layer(cache["global"], i), 0)
                local.append(lc)
                glob.append(gc)
            new_cache = {"local": _stack(local), "global": _stack(glob)}
        elif cfg.family in ("dense", "moe", "vlm"):
            window = cfg.sliding_window if self.long_context else 0
            kvs = []
            for i in range(cfg.n_layers):
                x, c2 = dense(_layer(params["blocks"], i), x, _layer(cache["kv"], i), window)
                kvs.append(c2)
            new_cache = {"kv": _stack(kvs)}
        elif cfg.family == "hybrid":
            def mamba2(block: Params, x: torch.Tensor, c: Params):
                y, c2 = mamba_lib.mamba2_decode(block["body"], rms_norm(x, block["ln"]), c,
                                                cfg.ssm_state)
                return x + y, c2

            supers, attns = [], []
            for i in range(self.n_super):
                blocks, states = _layer(params["mamba_blocks"], i), _layer(cache["mamba"], i)
                inner = []
                for j in range(self.mamba_per_super):
                    x, c2 = mamba2(_layer(blocks, j), x, _layer(states, j))
                    inner.append(c2)
                supers.append(_stack(inner))
                x, a2 = dense(params["shared_attn"], x, _layer(cache["attn"], i), 0)
                attns.append(a2)
            new_cache = {"mamba": _stack(supers), "attn": _stack(attns)}
            if self.n_tail:
                tails = []
                for i in range(self.n_tail):
                    x, c2 = mamba2(_layer(params["tail_blocks"], i), x, _layer(cache["tail"], i))
                    tails.append(c2)
                new_cache["tail"] = _stack(tails)
        elif cfg.family == "audio":
            kvs = []
            for i in range(cfg.n_layers):
                block = _layer(params["blocks"], i)
                h, c2 = attn_lib.decode_attention(
                    block["attn"], rms_norm(x, block["ln1"]), positions, _layer(cache["kv"], i),
                    softcap=cfg.attn_logit_softcap, rope_theta=cfg.rope_theta)
                x = x + h
                # the one token against every encoder frame: an all-true mask
                x = x + attn_lib.attention(
                    block["cross"], rms_norm(x, block["ln_cross"]), positions[:, None],
                    causal=False, use_rope=False,
                    kv_override=(cache["cross_k"][i], cache["cross_v"][i]), kv_positions=None)
                x = x + mlp(block["mlp"], rms_norm(x, block["ln2"]))
                kvs.append(c2)
            new_cache = {"kv": _stack(kvs), "cross_k": cache["cross_k"],
                         "cross_v": cache["cross_v"]}
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
    dense or moe arch."""
    return Model(cfg, long_context=shape_name == "long_500k", device=device)
