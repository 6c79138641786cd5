"""Architecture configs of the port: ``ArchConfig``, the input shapes and the
registry (``repro.configs.base`` without the ``jax.ShapeDtypeStruct`` specs).

The registry holds the ten architectures of the JAX package's:
smollm-360m, granite-3-2b, gemma2-2b and stablelm-12b (dense),
falcon-mamba-7b (ssm), qwen3-moe-30b-a3b and arctic-480b (moe), zamba2-7b
(hybrid), whisper-tiny (audio) and paligemma-3b (vlm).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple


@dataclass(frozen=True)
class ArchConfig:
    """One architecture. Every field that shapes parameters lives here."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    source: str  # citation from the assignment table

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    pad_heads_to: int = 0  # pad Q heads for TP divisibility (dead heads)
    pad_kv_heads_to: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    max_seq: int = 524_288

    # attention flavour
    attn_free: bool = False  # pure SSM (no attention at all)
    sliding_window: int = 0  # 0 = full attention
    alt_local_global: bool = False  # gemma2: alternate local/global layers
    attn_logit_softcap: float = 0.0  # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    rope_theta: float = 10_000.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_dense_residual: bool = False
    dense_ff: int = 0

    # SSM (mamba)
    ssm_state: int = 0
    ssm_version: int = 0  # 1 = mamba1, 2 = mamba2
    d_inner_mult: int = 2
    conv_width: int = 4
    ssm_sequential_scan: bool = False
    attn_every: int = 0
    shared_attn: bool = False

    # modality frontends (precomputed embeddings)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_frames: int = 1500
    n_patches: int = 0

    # numerics / training
    dtype: str = "bfloat16"
    optimizer: str = "adamw"
    optimizer_dtype: str = "float32"
    use_master_fp32: bool = True
    remat: bool = True
    seq_parallel: bool = True
    microbatches: int = 1

    # sharding recipe
    node_axes: Tuple[str, ...] = ("pod", "data")
    expert_axis: str = ""

    skip_shapes: Tuple[str, ...] = ()

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def eff_n_heads(self) -> int:
        return max(self.n_heads, self.pad_heads_to)

    @property
    def eff_n_kv_heads(self) -> int:
        return max(self.n_kv_heads, self.pad_kv_heads_to)

    @property
    def d_inner(self) -> int:
        return self.d_inner_mult * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, self.d_model // 16)

    def replace(self, **kw: Any) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke_variant(self) -> "ArchConfig":
        """Reduced config for CPU smoke tests: 2 layers, d_model<=512, <=4 experts."""
        kw: Dict[str, Any] = dict(
            n_layers=2,
            d_model=256,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads)),
            head_dim=64,
            d_ff=512,
            vocab=512,
            max_seq=4096,
            dtype="float32",
            optimizer_dtype="float32",
            remat=False,
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=min(2, self.top_k), d_ff=256)
            if self.moe_dense_residual:
                kw.update(dense_ff=256)
        if self.family == "hybrid":
            kw.update(attn_every=2, d_model=256, ssm_state=16)
        if self.attn_free or self.family == "hybrid":
            kw.update(ssm_state=16)
        if self.is_encoder_decoder:
            kw.update(n_encoder_layers=2, n_frames=64)
        if self.n_patches:
            kw.update(n_patches=16)
        if self.sliding_window:
            kw.update(sliding_window=128)
        return self.replace(**kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") from None


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (  # noqa: F401
        arctic_480b,
        falcon_mamba_7b,
        gemma2_2b,
        granite_3_2b,
        paligemma_3b,
        qwen3_moe_30b_a3b,
        smollm_360m,
        stablelm_12b,
        whisper_tiny,
        zamba2_7b,
    )
