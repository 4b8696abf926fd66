"""Alias of the reference's ``open_universe.networks``."""
from . import universe  # noqa: F401
