"""Models of the port: every family of the JAX package's."""
from .model import Batch, Model, build_model  # noqa: F401
