"""Weighted loss combiner (JAX package ``losses/combine.py``)."""
from __future__ import annotations

from typing import Dict, Tuple


class MultiLoss:
    """losses: {name: (weight, loss_fn)}; called on (y_hat, y), returns the
    weighted sum (and with ``with_dict`` each loss by name)."""

    def __init__(self, losses: Dict[str, Tuple[float, object]]):
        self.weights = {k: v[0] for k, v in losses.items()}
        self.losses = {k: v[1] for k, v in losses.items()}

    def __call__(self, y_hat, y, with_dict: bool = False):
        loss = 0.0
        loss_dict = {}
        for name, loss_fn in self.losses.items():
            loss_dict[name] = loss_fn(y_hat, y)
            loss = loss + self.weights[name] * loss_dict[name]
        if with_dict:
            return loss, loss_dict
        return loss
