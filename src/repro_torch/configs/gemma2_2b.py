"""gemma2-2b — local+global alternating attention, logit softcaps
[arXiv:2408.00118]."""
from .base import ArchConfig, register

GEMMA2_2B = register(ArchConfig(
    name="gemma2-2b",
    family="dense",
    source="arXiv:2408.00118",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    alt_local_global=True,
    sliding_window=4096,   # local layers' window (native to gemma2)
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    node_axes=("pod", "data"),
))
