"""paligemma-3b — SigLIP + gemma VLM; vision encoder/projector is a STUB
(precomputed patch embeddings) per the assignment. [arXiv:2407.07726]"""
from .base import ArchConfig, register

PALIGEMMA_3B = register(ArchConfig(
    name="paligemma-3b",
    family="vlm",
    source="arXiv:2407.07726",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,   # MQA
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    n_patches=256,
    sliding_window=4096,  # long_500k variant only
    node_axes=("pod", "data"),
))
