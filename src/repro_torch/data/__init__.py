"""Synthetic federated data of the port (``repro.data``)."""
from .pipeline import DataConfig, FederatedData, SiloDataset  # noqa: F401
