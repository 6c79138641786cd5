"""granite-3-2b — dense GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from .base import ArchConfig, register

GRANITE_3_2B = register(ArchConfig(
    name="granite-3-2b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-2b-base",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=49155,
    sliding_window=4096,  # long_500k variant only
    node_axes=("pod", "data"),
))
