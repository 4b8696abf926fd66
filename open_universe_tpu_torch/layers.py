"""Alias of the reference's ``open_universe.layers`` (its
``layers/__init__.py`` exports the dynamic-range-compression transforms)."""
from .models.transforms import (  # noqa: F401
    CompressedMagSTFT,
    CompressedMagSTFTPadded,
    IdentityTransform,
)
