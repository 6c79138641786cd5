"""whisper-tiny — enc-dec audio backbone; conv/mel frontend is a STUB
(precomputed frame embeddings) per the assignment. [arXiv:2212.04356]"""
from .base import ArchConfig, register

WHISPER_TINY = register(ArchConfig(
    name="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=4,             # decoder layers
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    is_encoder_decoder=True,
    n_frames=1500,
    node_axes=("pod", "data"),
    # full-attention enc-dec with a 448-position decoder: a 524k sliding-window
    # decoder has no modelling meaning (DESIGN.md §Arch-applicability).
    skip_shapes=("long_500k",),
))
