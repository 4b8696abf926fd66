"""Batch amplitude normalisation (reference utils/norm.py).

Waveforms are (B, T, C); statistics run over all non-batch axes.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def _norm2(signal: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # ddof=1: torch.Tensor.std's default Bessel correction, as the reference
    return torch.clamp(torch.std(signal, dim=(1, 2), keepdim=True, correction=1),
                       min=eps)


def _norm_max(signal: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    m = torch.amax(torch.abs(signal.reshape(signal.shape[0], -1)), dim=1)
    return torch.clamp(m[:, None, None], min=eps)


def _compute_gain(signal, norm, level, eps=1e-5):
    if norm in (2, "2"):
        return level / _norm2(signal, eps)
    if norm == "max":
        return level / _norm_max(signal, eps)
    if norm == "2-max":
        return torch.minimum(level / _norm2(signal, eps),
                             1.0 / _norm_max(signal, eps))
    raise NotImplementedError(f"norm {norm!r} not implemented")


def normalize_batch(batch: Sequence[Optional[torch.Tensor]], norm=2,
                    level_db=0.0, ref="noisy", eps=1e-5, zero_mean=True):
    """Normalise (mix, *targets) to a level in dB.

    ref='noisy' scales the targets with the mix's gain; ref='both' normalises
    each signal on its own.  Returns (signals, mean, std) of the mix's
    scaling, for denormalize_batch.
    """
    if ref not in ("noisy", "both"):
        raise ValueError(f"ref must be noisy|both, got {ref!r}")
    level = 10.0 ** (level_db / 20.0)
    mix, *others = batch
    if zero_mean:
        mean = torch.mean(mix, dim=(1, 2), keepdim=True)
        mix = mix - mean
    else:
        mean = 0.0
    gain = _compute_gain(mix, norm, level, eps)
    mix = mix * gain

    out = [mix]
    for tgt in others:
        if tgt is not None:
            if ref == "both":
                if zero_mean:
                    tgt = tgt - torch.mean(tgt, dim=(1, 2), keepdim=True)
                tgt = tgt * _compute_gain(tgt, norm, level, eps)
            else:
                tgt = (tgt - mean) * gain
        out.append(tgt)
    return out, mean, 1.0 / gain


def denormalize_batch(x, mean, std):
    return x * std + mean
