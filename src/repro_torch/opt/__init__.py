"""Overlay optimization of the port: the :class:`OptimizerSpec` declaration
only (``repro.opt``'s search, objectives and state are not ported)."""
from .search import OBJECTIVE_NAMES, STRATEGIES, OptimizerSpec  # noqa: F401
