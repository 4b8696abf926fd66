"""Core utilities (JAX package ``utils/__init__.py``, reference
open_universe/utils/__init__.py surface).

``AutoClipper``, ``FixedClipper`` and ``grad_norm`` live in ``train/optim``
and are re-exported lazily, which keeps this package free of an import
cycle.
"""
from .norm import denormalize_batch, normalize_batch  # noqa: F401
from .params import (  # noqa: F401
    at_least_f32,
    count_parameters,
    count_parameters_per_level,
    pad_dim_right,
    to_device,
)
from .random import center_truncated_normal  # noqa: F401
from .stats import signal_median  # noqa: F401

_OPTIM_NAMES = {"AutoClipper": "AutoClipper", "FixedClipper": "FixedClipper",
                "grad_norm": "global_norm"}


def __getattr__(name):
    if name in _OPTIM_NAMES:
        from ..train import optim

        return getattr(optim, _OPTIM_NAMES[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
