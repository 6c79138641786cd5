"""arctic-480b — 128-expert top-2 MoE with dense residual MLP
[hf:Snowflake/snowflake-arctic-base]."""
from .base import ArchConfig, register

ARCTIC_480B = register(ArchConfig(
    name="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab=32000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    dense_ff=4864,
    sliding_window=4096,  # long_500k variant only
    optimizer="adafactor",  # factored 2nd moment: full Adam state at 480B
                            # cannot fit a per-node replica's chips
    optimizer_dtype="bfloat16",
    use_master_fp32=False,
    microbatches=8,  # gradient accumulation: bounds activation memory
    # a full replica per 16-chip group is impossible at 480B; nodes are pods,
    # the "data" axis carries expert parallelism (DESIGN.md §4).
    node_axes=("pod",),
    expert_axis="data",
))
