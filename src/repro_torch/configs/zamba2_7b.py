"""zamba2-7b — Mamba2 + shared attention blocks (hybrid) [arXiv:2411.15242]."""
from .base import ArchConfig, register

ZAMBA2_7B = register(ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_version=2,
    attn_every=6,      # one (shared) attention block every 6 layers
    shared_attn=True,  # zamba2 reuses the same attention block weights
    optimizer_dtype="bfloat16",
    node_axes=("pod", "data"),
))
