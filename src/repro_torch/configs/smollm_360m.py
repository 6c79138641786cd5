"""smollm-360m — llama-arch small dense GQA [hf:HuggingFaceTB/SmolLM-135M]."""
from .base import ArchConfig, register

SMOLLM_360M = register(ArchConfig(
    name="smollm-360m",
    family="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab=49152,
    sliding_window=4096,  # enabled only for the long_500k variant (see model.py)
    node_axes=("pod", "data"),
))
