"""LoRA adapters (JAX package ``nn/lora.py``, reference ``lora/`` package).

``inject`` wraps every ``Conv1d``, ``ConvTranspose1d`` and ``Linear`` under a
module in an adapter module that keeps the reference's ``state_dict`` names:

    LoraConv1d / LoraConvTranspose1d   .conv (the base layer),
                                       .lora_weight_a (dim0, r), .lora_weight_b (r, rest)
    LoraLinear                         .linear (the base layer),
                                       .lora_linear_a (Out, r), .lora_linear_b (r, In)

where (dim0, rest) is the base weight in torch layout flattened after its
first axis: (Cout, Cin/g * K) for a conv, (Cin, Cout * K) for a transposed
conv, (Out, In) for a linear.  An adapter computes with

    W_eff = W + (alpha / r) * reshape(A @ B, W.shape)

(merged-apply: one convolution, no extra branch).  The weights are in torch
layout, so a transposed conv's delta is the plain reshape; the JAX package
flips its taps for its own layout.  ``remove`` folds the adapters back into
plain layers; ``set_trainable`` sets ``requires_grad`` for the adapters,
the biases and the names asked for (the JAX package's ``trainable_mask_lora``).

An adapter is never a folded plain layer: ``ConvBlock._fused_eligible``
refuses a chain that holds one, so the fused kernel, which reads the base
weight, never computes without the adapters.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops import conv as ops_conv
from ..parallel import tp
from .layers import Conv1d, ConvTranspose1d, Linear

LORA_TYPES = (Conv1d, ConvTranspose1d, Linear)


def _dims(base: nn.Module) -> tuple:
    """(dim0, rest) of the base weight in torch layout, and min(cin, cout)
    for the rank check (reference lora.py:60-63)."""
    if isinstance(base, Conv1d):
        cin = base.in_channels // base.groups
        return base.out_channels, cin * base.kernel_size, min(cin, base.out_channels)
    if isinstance(base, ConvTranspose1d):
        return (base.in_channels, base.out_channels * base.kernel_size,
                min(base.in_channels, base.out_channels))
    if isinstance(base, Linear):
        return base.out_features, base.in_features, min(base.in_features, base.out_features)
    raise TypeError(type(base))


class LoraLayer(nn.Module):
    """A base layer with a rank-r update.  Convs start with A = 0 and B
    normal (reference lora.py:65-68), a linear with A normal and B = 0
    (lora.py:228-229): either way A @ B starts at zero."""

    def __init__(self, base: nn.Module, rank: int, alpha: Optional[float],
                 generator: torch.Generator):
        super().__init__()
        if isinstance(base, Linear):
            self.nest, self.a_name, self.b_name = "linear", "lora_linear_a", "lora_linear_b"
        else:
            self.nest, self.a_name, self.b_name = "conv", "lora_weight_a", "lora_weight_b"
        self.add_module(self.nest, base)
        self.rank = rank
        self.lora_alpha = float(alpha) if alpha is not None else float(rank)
        d0, rest, _ = _dims(base)
        like = next(base.parameters())
        if isinstance(base, Linear):
            a = torch.randn((d0, rank), generator=generator)
            b = torch.zeros((rank, rest))
        else:
            a = torch.zeros((d0, rank))
            b = torch.randn((rank, rest), generator=generator)
        self.register_parameter(self.a_name, nn.Parameter(a.to(like.device)))
        self.register_parameter(self.b_name, nn.Parameter(b.to(like.device)))

    @property
    def base(self) -> nn.Module:
        return getattr(self, self.nest)

    def delta(self) -> torch.Tensor:
        """(alpha / r) * A @ B in the base weight's torch layout."""
        a, b = tp.weight(self, self.a_name), tp.weight(self, self.b_name)
        base = self.base
        shape = tp.full_shape(base, "weight" if base.folded else "weight_v")
        return ((a @ b) * (self.lora_alpha / self.rank)).reshape(shape)

    def effective_weight(self) -> torch.Tensor:
        return self.base.effective_weight() + self.delta()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        base, w = self.base, self.effective_weight()
        if isinstance(base, Conv1d):
            return ops_conv.conv1d(x, w, base.bias, stride=base.stride,
                                   padding=base.padding, dilation=base.dilation,
                                   groups=base.groups)
        if isinstance(base, ConvTranspose1d):
            return ops_conv.conv_transpose1d(x, w, base.bias, stride=base.stride,
                                             padding=base.padding)
        return ops_conv.linear(x, w, base.bias)


def inject(module: nn.Module, rank: int, alpha: Optional[float] = None,
           generator: Optional[torch.Generator] = None) -> nn.Module:
    """Wrap every Conv1d, ConvTranspose1d and Linear under ``module`` in a
    ``LoraLayer``, in place, drawing the adapters in module order from
    ``generator`` (seed 0 when None).  A layer whose min(cin // groups,
    cout) is below the rank is left as it is (reference lora/utils.py:47-69)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for name, child in list(module.named_children()):
        if isinstance(child, LORA_TYPES):
            if _dims(child)[2] >= rank:
                setattr(module, name, LoraLayer(child, rank, alpha, generator))
        elif not isinstance(child, LoraLayer):
            inject(child, rank, alpha, generator)
    return module


@torch.no_grad()
def remove(module: nn.Module) -> nn.Module:
    """Fold every adapter under ``module`` into its base layer's weight and
    put the base layer back in its place, in place.  Raises on a
    weight-normed base (fold weight norm first).  The fused kernel's weight
    caches are dropped, so no ConvBlock reuses the unmerged weights."""
    for name, child in list(module.named_children()):
        if isinstance(child, LoraLayer):
            base = child.base
            if not base.folded:
                raise ValueError("remove weight norm before folding LoRA")
            base.weight = nn.Parameter(base.weight + child.delta(),
                                       requires_grad=base.weight.requires_grad)
            setattr(module, name, base)
        else:
            remove(child)
    if hasattr(module, "_chain_cache"):
        module._chain_cache = {}
    return module


def set_trainable(module: nn.Module, train_biases: bool = True,
                  train_names: Sequence[str] = ()) -> list:
    """``requires_grad`` on the parameters fine-tuning trains, off on the
    rest (JAX ``trainable_mask_lora``, the reference's
    ``freeze_parameters_except_lora_and_bias``): every ``lora_*`` leaf,
    every leaf whose name holds ``bias`` (with ``train_biases``) and every
    path that holds one of ``train_names``.  Returns the trainable names."""
    names = []
    for path, p in module.named_parameters():
        leaf = path.rsplit(".", 1)[-1]
        train = ("lora_" in leaf or any(s in path for s in train_names)
                 or (train_biases and "bias" in leaf))
        p.requires_grad_(train)
        if train:
            names.append(path)
    return names
