"""Diffusion sigma embeddings (reference sigma_block.py).

SigmaBlock: random Fourier features of log10(sigma) -> 3 Linear-PReLU layers.
SimpleTimeEmbedding: 2-parameter learned sinusoid (UNIVERSE++ default).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Linear, PReLU


class LinearPReLU(nn.Module):
    """prelu(lin(x)) with the reference's child names."""

    def __init__(self, in_features, out_features):
        super().__init__()
        self.prelu = PReLU()
        self.lin = Linear(in_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(self.lin(x))


class SigmaBlock(nn.Module):
    """Random Fourier features of log10(sigma); ``freq`` is a buffer drawn at
    init and restored from checkpoints."""

    def __init__(self, n_rff: int = 32, n_dim: int = 256, scale: float = 16.0):
        super().__init__()
        self.n_rff = n_rff
        self.scale = scale
        self.register_buffer("freq", torch.zeros(n_rff))
        self.layer1 = LinearPReLU(2 * n_rff, 4 * n_rff)
        self.layer2 = LinearPReLU(4 * n_rff, 8 * n_rff)
        self.layer3 = LinearPReLU(8 * n_rff, n_dim)

    @torch.no_grad()
    def seed_parameters(self, generator: torch.Generator):
        self.freq.copy_(self.scale * torch.randn(self.n_rff, generator=generator))

    def forward(self, log10_sigma: torch.Tensor) -> torch.Tensor:
        """log10_sigma: (B,) -> (B, n_dim)."""
        freq = self.freq.to(log10_sigma.dtype)
        p = 2.0 * math.pi * freq[None, :] * log10_sigma[:, None]
        g = torch.cat([torch.sin(p), torch.cos(p)], dim=-1)
        return self.layer3(self.layer2(self.layer1(g)))


class SimpleTimeEmbedding(nn.Module):
    """Sinusoid with a learned continuous frequency (sigma_block.py:60-78)."""

    def __init__(self, n_dim: int = 256):
        super().__init__()
        self.n_dim = n_dim
        self.weight = nn.Parameter(torch.zeros(1, 1))
        self.bias = nn.Parameter(torch.zeros(1, 1))

    @torch.no_grad()
    def seed_parameters(self, generator: torch.Generator):
        self.weight.zero_()
        self.bias.zero_()

    def forward(self, log10_sigma: torch.Tensor) -> torch.Tensor:
        dtype = log10_sigma.dtype
        time = torch.arange(self.n_dim // 2, dtype=dtype,
                            device=log10_sigma.device)
        f = 0.5 * torch.sigmoid(self.weight.to(dtype) * log10_sigma[:, None]
                                + self.bias.to(dtype))
        p = 2.0 * math.pi * f * time
        return torch.cat([torch.sin(p), torch.cos(p)], dim=-1)
