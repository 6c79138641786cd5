"""Optimizers of the port (``repro.optim``)."""
from .optimizers import (  # noqa: F401
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    constant_schedule,
    cosine_schedule,
    global_norm,
    linear_schedule,
    make_optimizer,
    momentum_sgd,
    sgd,
)
