"""Config registry of the port: the JAX package's ten architectures."""
from .base import (  # noqa: F401
    INPUT_SHAPES,
    ArchConfig,
    InputShape,
    get_arch,
    input_specs,
    list_archs,
    register,
)
