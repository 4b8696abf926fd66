"""Mixture density network loss of the plain UNIVERSE (JAX package
``models/mdn.py``, reference networks/universe/mdn.py).

The Gaussian-mixture negative log-likelihood of a target under a head on an
estimate: a LayerNorm over (channels, time) of the (B, C, T) view, whose
affine shape pins the training crop at ``int(sampling_rate *
sample_len_s)`` samples, then a PReLU conv to (mean, sigma, alpha) for each
of ``n_comp`` components and target channels.  The loss is train-time only.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import PReLUConv
from ..nn.layers import LayerNorm


def elu2(x: torch.Tensor, alpha: float = 1.0, eps: float = 1e-15) -> torch.Tensor:
    return F.elu(x, alpha) + 1.0 + eps


class MixtureDensityNetworkLoss(nn.Module):
    def __init__(self, est_channels, tgt_channels, n_comp=3, eps=1e-5,
                 sampling_rate=24000, sample_len_s=3.0, sigma_eps=1e-5,
                 alpha_per_sample=False, reduction="mean"):
        super().__init__()
        if reduction not in ("mean", "sum", "none"):
            raise ValueError("reduction must be mean|sum|none")
        self.reduction = reduction
        self.alpha_per_sample = alpha_per_sample
        self.n_comp = n_comp
        self.tgt_channels = tgt_channels
        self.eps = eps
        self.sigma_eps = sigma_eps
        self.seq_len = int(sampling_rate * sample_len_s)
        self.layer_norm = LayerNorm((est_channels, self.seq_len))
        self.conv = PReLUConv(est_channels, 3 * n_comp * tgt_channels, 3, padding="same")

    def forward(self, est: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """est: (B, T, C_est); tgt: (B, T, C_tgt), or (B, C, T, M) (the
        2-channel mel of ``with_noise_target``), folded channel-major into
        (B, T, C * M) as the reference's ``tgt.flatten(1, -2)``."""
        if tgt.dim() == 4:
            b4, c4, f4, m4 = tgt.shape
            tgt = tgt.transpose(1, 2).reshape(b4, f4, c4 * m4)
        if est.shape[1] != self.seq_len:
            raise ValueError(f"the MDN loss's LayerNorm takes {self.seq_len} frames (the "
                             f"training crop), got {est.shape[1]}")
        e = self.layer_norm(est.transpose(1, 2)).transpose(1, 2)
        e = self.conv(e)  # (B, T, 3 * n_comp * tgt)
        b, t, _ = e.shape
        e = e.reshape(b, t, 3, self.n_comp, self.tgt_channels)
        # a diverged estimate (|mean| huge, sigma -> eps) would send the NLL
        # to inf; the clips are far outside the healthy range (unit-
        # normalised targets)
        mean = torch.clamp(e[:, :, 0], -1e4, 1e4)
        sigma = elu2(torch.clamp(e[:, :, 1], -1e4, 1e4), eps=self.sigma_eps)
        alpha = e[:, :, 2]  # (B, T, comp, tgt)
        if self.alpha_per_sample:
            alpha = torch.mean(alpha, dim=3, keepdim=True)
        else:
            alpha = torch.mean(alpha, dim=(1, 3), keepdim=True)
        log_alpha = F.log_softmax(torch.clamp(alpha, min=-10.0), dim=2)

        log_p = -0.5 * torch.square((tgt[:, :, None, :] - mean) / sigma)
        log_p = log_p - torch.log(math.sqrt(2.0 * math.pi) * sigma) + log_alpha
        log_p = torch.sum(log_p, dim=(1, 3))  # (B, comp)
        nll = -torch.logsumexp(log_p, dim=-1) / (t * self.tgt_channels)
        if self.reduction == "mean":
            return torch.mean(nll)
        if self.reduction == "sum":
            return torch.sum(nll)
        return nll

    @staticmethod
    def sample(logit: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
               random: bool = True, generator: Optional[torch.Generator] = None,
               gumbel: Optional[torch.Tensor] = None,
               z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A draw from the mixture (reference mdn.py:127-157).  logit: (B,
        comp, T); mean, std: (B, comp, D, T) -> (B, D, T).  ``random`` picks
        each frame's component by the Gumbel-max rule (``gumbel`` (B, T,
        comp) draws) and adds ``z`` (B, 1, D, T) standard-normal noise, both
        from ``generator`` unless given; otherwise the likeliest component's
        mean."""
        b, _, d, t = mean.shape
        if random:
            if gumbel is None:
                u = torch.rand(b, t, logit.shape[1], generator=generator,
                               device=logit.device).clamp_(min=torch.finfo(torch.float32).tiny)
                gumbel = -torch.log(-torch.log(u))
            idx = torch.argmax(logit.transpose(1, 2) + gumbel.to(logit.device), dim=-1)
            if z is None:
                z = torch.randn(b, 1, d, t, generator=generator, device=mean.device)
            idx4 = idx[:, None, None, :].expand(b, 1, d, t)
            out = z.to(mean) * torch.gather(std, 1, idx4) + torch.gather(mean, 1, idx4)
            return out[:, 0]
        idx = torch.argmax(logit, dim=1)
        return torch.gather(mean, 1, idx[:, None, None, :].expand(b, 1, d, t))[:, 0]
