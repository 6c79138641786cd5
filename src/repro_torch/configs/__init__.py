"""Config registry of the port: the eight architectures whose families it runs."""
from .base import (  # noqa: F401
    INPUT_SHAPES,
    ArchConfig,
    InputShape,
    get_arch,
    list_archs,
    register,
)
