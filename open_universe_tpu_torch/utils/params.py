"""Parameter and tensor utilities (JAX package ``utils/params.py``,
reference utils/torch_utils.py).

The JAX package counts the leaves of parameter pytrees; here a "parameter
tree" is an ``nn.Module`` (its named parameters), a dict of tensors (a
``state_dict``, nested dicts allowed) or a sequence of tensors.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


def _named_leaves(params, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(params, nn.Module):
        yield from params.named_parameters(prefix=prefix.rstrip("."))
    elif isinstance(params, dict):
        for k, v in params.items():
            yield from _named_leaves(v, f"{prefix}{k}.")
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from _named_leaves(v, f"{prefix}{i}.")
    elif hasattr(params, "shape"):
        yield prefix.rstrip("."), params


def count_parameters(params) -> int:
    """Total number of scalar parameters (reference utils/torch_utils.py:24-28)."""
    return sum(int(np.prod(tuple(a.shape))) for _, a in _named_leaves(params))


def count_parameters_per_level(params, max_level: int = 2) -> Dict[str, int]:
    """Parameter counts grouped by dotted prefix up to ``max_level``
    (reference utils/torch_utils.py:31-43); key "" is the grand total."""
    counts: Dict[str, int] = defaultdict(int)
    for name, leaf in _named_leaves(params):
        names = name.split(".")
        c = int(np.prod(tuple(leaf.shape)))
        counts[""] += c
        for idx in range(min(max_level, len(names))):
            counts[".".join(names[: idx + 1])] += c
    return dict(counts)


def pad_dim_right(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast ``a`` over the trailing dimensions of ``x``
    (reference utils/torch_utils.py:70-75)."""
    if tuple(a.shape) != tuple(x.shape[: a.dim()]):
        raise ValueError("All left dimensions of a and x should be matching")
    return a[(...,) + (None,) * (x.dim() - a.dim())]


def to_device(data: Any, device="cpu", to_numpy: bool = False) -> Any:
    """Recursively move tensors between devices (reference
    utils/torch_utils.py:46-67).  ``to_numpy`` also turns them into numpy
    arrays, and needs ``device`` "cpu"; numpy arrays go to ``device`` as
    tensors unless it is "cpu"."""
    if to_numpy and str(device) != "cpu":
        raise ValueError("to_numpy and an accelerator device are not compatible")
    if isinstance(data, (list, tuple)):
        return type(data)(to_device(d, device, to_numpy) for d in data)
    if isinstance(data, dict):
        return {k: to_device(v, device, to_numpy) for k, v in data.items()}
    if isinstance(data, torch.Tensor):
        out = data.to(device)
        return out.numpy() if to_numpy else out
    if isinstance(data, np.ndarray) and str(device) != "cpu":
        return torch.as_tensor(data, device=device)
    return data


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Promote to float32 unless the input is already wider: the boundary
    of mixed-precision training, where the networks' bf16 outputs enter the
    float32 losses (a float64 run stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
