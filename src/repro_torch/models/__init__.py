"""Models of the port: the dense and ssm (Mamba1) families."""
from .model import Batch, Model, build_model  # noqa: F401
