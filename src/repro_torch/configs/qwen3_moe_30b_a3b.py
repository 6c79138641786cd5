"""qwen3-moe-30b-a3b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B]."""
from .base import ArchConfig, register

QWEN3_MOE_30B_A3B = register(ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,          # per-expert intermediate size
    vocab=151936,
    n_experts=128,
    top_k=8,
    sliding_window=4096,  # long_500k variant only
    optimizer_dtype="bfloat16",
    node_axes=("pod",),
    expert_axis="data",
))
