"""stablelm-12b — dense GQA [hf:stabilityai/stablelm-2-1_6b]."""
from .base import ArchConfig, register

STABLELM_12B = register(ArchConfig(
    name="stablelm-12b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab=100352,
    sliding_window=4096,  # long_500k variant only
    optimizer_dtype="bfloat16",
    node_axes=("pod", "data"),
))
