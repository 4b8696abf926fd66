"""Alias of the reference's ``open_universe.datasets``."""
from .data.dataset import DataLoader, DataModule, NoisyDataset, collate  # noqa: F401
