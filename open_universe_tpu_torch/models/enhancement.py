"""The enhancement family's base model (JAX package
``models/enhancement.py``, reference networks/enhancement/base.py).

``EnhancementBaseModel`` trains a predictive waveform-to-waveform network
with a weighted stack of losses: ``losses`` is one loss node (a
``_target_``) or ``{name: {weight, kwargs}}`` (a node with a ``_target_``
counts with weight 1; ``name: null`` disables a loss).  ``training_losses``
applies ``training.dynamic_mixing`` (the batch's noise permuted),
normalises and runs the network; ``validation_losses`` does the same
without the mixing; ``enhance`` normalises, runs the network, denormalises,
with ``keep_rms`` and the clip.  ``UniverseLoRA`` (``models/universe_lora.py``)
has the same training surface.  As in the JAX package no config target
names this class.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.norm import (
    as_batch, clip_protect, denormalize_batch, like_input, normalize_batch, rms,
)


def build_losses(losses: Optional[dict]) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """(functions, weights) by name of a ``losses`` node."""
    from ..configs.registry import instantiate

    funcs: Dict[str, Any] = {}
    weights: Dict[str, float] = {}
    cfg = losses or {}
    if "_target_" in cfg:
        return {"loss": instantiate(cfg)}, {"loss": 1.0}
    for name, node in cfg.items():
        if node is None:  # `model.losses.<name>=null` disables a loss
            continue
        if isinstance(node, dict) and "_target_" in node:
            funcs[name], weights[name] = instantiate(node), 1.0
        elif isinstance(node, dict):
            funcs[name], weights[name] = instantiate(node.get("kwargs")), node.get("weight", 1.0)
        else:
            funcs[name], weights[name] = node, 1.0
    return funcs, weights


class EnhancementBaseModel(nn.Module):
    def __init__(self, fs, normalization_norm=2, model: Optional[nn.Module] = None,
                 losses: Optional[dict] = None, training: Optional[dict] = None,
                 validation: Optional[dict] = None, optimizer: Optional[dict] = None,
                 scheduler: Optional[dict] = None, grad_clipper: Optional[dict] = None,
                 normalization_kwargs: Optional[dict] = None):
        from ..configs.registry import instantiate

        super().__init__()
        self.fs = fs
        self.normalization_norm = normalization_norm
        self.normalization_kwargs = dict(normalization_kwargs or {})
        self.train_kwargs = dict(training or {})
        self.val_kwargs = dict(validation or {})
        self.opt_kwargs = optimizer
        self.schedule_kwargs = scheduler
        self.grad_clip_kwargs = grad_clipper
        self.model = model if isinstance(model, nn.Module) else instantiate(model)
        self.losses_func, self.losses_weights = build_losses(losses)

    def model_param_keys(self):
        return ("model",)

    def loss_param_keys(self):
        return ()

    def normalize_batch(self, batch, norm=None):
        if norm is None:
            norm = self.normalization_norm
        return normalize_batch(batch, norm=norm, **self.normalization_kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The network on (B, T, C), its output right-padded to T."""
        ret = self.model(x)
        if isinstance(ret, (list, tuple)):
            ret = ret[0]
        if ret.shape[1] < x.shape[1]:
            ret = F.pad(ret, (0, 0, 0, x.shape[1] - ret.shape[1]))
        return ret

    def compute_losses(self, enh: torch.Tensor, target: torch.Tensor):
        loss = enh.new_zeros((), dtype=torch.float32)
        losses = {}
        for name, fn in self.losses_func.items():
            losses[name] = fn(enh, target)
            loss = loss + self.losses_weights[name] * losses[name]
        return loss, losses

    def training_losses(self, mix: torch.Tensor, target: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[Dict[str, Any]] = None,
                        rows: Optional[slice] = None):
        """(loss, metrics) on a raw (B, T, C) batch; ``draws["perm"]`` gives
        dynamic mixing's permutation, else it comes from ``generator``.
        ``rows``: a data-parallel rank's rows (``parallel/mesh.py``), taken
        after the mixing."""
        if self.train_kwargs.get("dynamic_mixing", False):
            perm = (draws or {}).get("perm")
            if perm is None:
                perm = torch.randperm(mix.shape[0], generator=generator, device=mix.device)
            mix = target + (mix - target)[torch.as_tensor(perm, device=mix.device)]
        (mix, target), *_ = self.normalize_batch((mix, target))
        if rows is not None:
            mix, target = mix[rows], target[rows]
        loss, losses = self.compute_losses(self.forward(mix), target)
        return loss, {"train/main_loss": loss, **{f"train/{k}": v for k, v in losses.items()}}

    def validation_losses(self, mix: torch.Tensor, target: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[Dict[str, Any]] = None):
        """The losses without dynamic mixing (reference base.py:382-407)."""
        (mix, target), *_ = self.normalize_batch((mix, target))
        loss, losses = self.compute_losses(self.forward(mix), target)
        return loss, {"val/main_loss": loss, **{f"val/{k}": v for k, v in losses.items()}}

    @torch.no_grad()
    def enhance(self, mix, keep_rms: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Normalise (the JAX package's defaults), run the network,
        denormalise; ``keep_rms`` restores the mix's RMS; clip protection.
        A predictive network draws nothing: ``generator`` is not used."""
        device = next(self.parameters()).device
        mix = torch.as_tensor(mix, device=device).float()
        ndim = mix.dim()
        mix = as_batch(mix)
        mix_rms = rms(mix)
        (x, _), mean, std = normalize_batch((mix, None))
        x = denormalize_batch(self.forward(x), mean, std)
        if keep_rms:
            x = x * mix_rms / torch.clamp(rms(x), min=1e-5)
        return like_input(clip_protect(x), ndim)
