"""Exponential moving average of the model's parameters (JAX package
``train/ema.py``; torch_ema's rule with ``use_num_updates``):

    decay_t = min(decay, (1 + t) / (10 + t))
    shadow  = shadow - (1 - decay_t) * (shadow - param)

over the parameters of ``model.model_param_keys()`` (the loss modules are
left out), in ``state_dict`` order: the order of a reference checkpoint's
EMA shadow list.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn


class EMA:
    def __init__(self, model: nn.Module, decay: float):
        self.decay = decay
        self.num_updates = 0
        self.params: Dict[str, nn.Parameter] = {
            f"{sub}.{name}": p for sub in model.model_param_keys()
            for name, p in getattr(model, sub).named_parameters()}
        self.shadow = {k: p.detach().clone() for k, p in self.params.items()}

    @torch.no_grad()
    def update(self) -> None:
        self.num_updates += 1
        t = self.num_updates
        d = min(self.decay, (1.0 + t) / (10.0 + t))
        for k, s in self.shadow.items():
            s.sub_((1.0 - d) * (s - self.params[k]))

    @torch.no_grad()
    def apply_to(self, model: nn.Module) -> None:
        """Write the shadows into ``model``'s parameters (a model of the same
        structure, e.g. one loaded for evaluation)."""
        own = dict(model.named_parameters())
        for k, s in self.shadow.items():
            own[k].copy_(s)
