"""Checkpoints of the port (``repro.checkpoint``), in the same on-disk format."""
from .checkpoint import (  # noqa: F401
    load_metadata, node_checkpoint_path, restore_pytree, save_pytree,
)
