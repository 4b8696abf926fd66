"""Multi-resolution L1 time + STFT-magnitude loss (JAX package
``losses/multires_stft.py``, ESPnet-derived)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.stft import stft


class MultiResL1SpecLoss:
    """w * L1_time + (1 - w) * mean over windows of L1_magnitude.

    Each window's STFT is torchaudio's ``Spectrogram(center=True,
    pad_mode='constant', power=None)``: periodic Hann, hop ``hop_sz``
    (half the window by default).  ``scale_invariant`` projects the estimate
    onto the target first.  Inputs are (B, T) or (B, T, 1) waveforms;
    computed in at least float32.
    """

    def __init__(self, window_sz: Sequence[int] = (512,),
                 hop_sz: Optional[Sequence[int]] = None, eps: float = 1e-8,
                 time_domain_weight: float = 0.5, scale_invariant: bool = False):
        if not all(x % 2 == 0 for x in window_sz):
            raise ValueError(f"window sizes must be even, got {list(window_sz)}")
        self.window_sz = list(window_sz)
        self.hop_sz = list(hop_sz) if hop_sz is not None else [x // 2 for x in window_sz]
        self.eps = eps
        self.time_domain_weight = time_domain_weight
        self.scale_invariant = scale_invariant

    def __call__(self, estimate: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if estimate.dim() == 3 and estimate.shape[-1] == 1:
            estimate = estimate[..., 0]
        if target.dim() == 3 and target.shape[-1] == 1:
            target = target[..., 0]
        dtype = torch.promote_types(estimate.dtype, torch.float32)
        estimate, target = estimate.to(dtype), target.to(torch.promote_types(
            target.dtype, torch.float32))

        if self.scale_invariant:
            scaling = torch.sum(estimate * target, -1, keepdim=True) / (
                torch.sum(estimate**2, -1, keepdim=True) + self.eps)
            estimate = estimate * scaling

        dims = tuple(range(1, target.dim()))
        time_loss = torch.mean(torch.abs(estimate - target), dim=dims)
        if not self.window_sz:
            return torch.mean(time_loss)

        spec_loss = torch.zeros_like(time_loss)
        for w, h in zip(self.window_sz, self.hop_sz):
            tm = torch.abs(stft(target, w, h, center=True, pad_mode="constant"))
            em = torch.abs(stft(estimate, w, h, center=True, pad_mode="constant"))
            spec_loss = spec_loss + torch.mean(torch.abs(em - tm),
                                               dim=tuple(range(1, tm.dim())))
        total = (time_loss * self.time_domain_weight
                 + (1.0 - self.time_domain_weight) * spec_loss / len(self.window_sz))
        return torch.mean(total)
