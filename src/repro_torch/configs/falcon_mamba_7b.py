"""falcon-mamba-7b — attention-free Mamba1 [arXiv:2410.05355]."""
from .base import ArchConfig, register

FALCON_MAMBA_7B = register(ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    source="arXiv:2410.05355",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    attn_free=True,
    ssm_state=16,
    ssm_version=1,
    d_inner_mult=2,
    conv_width=4,
    optimizer_dtype="bfloat16",
    node_axes=("pod", "data"),
))
