"""Data-preparation utilities (reference open_universe/prepare)."""
from . import resample  # noqa: F401
