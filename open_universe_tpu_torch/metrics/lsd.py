"""Log-spectral distance (reference metrics/lsd.py; the JAX package's
``metrics/lsd.py`` in torch, on the port's ``ops/stft.py``).

Uses window-normalised power spectrograms (torchaudio ``normalized='window'``
divides the STFT by ||window||_2).  It runs on the device of its input, so
validation computes it where the enhanced batch lies.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.stft import hann_window, stft


def _log_power_spec(x, n_fft, hop, win_length, window, eps, db):
    z = stft(x, n_fft, hop, win_length=win_length, window=window, center=True)
    wnorm = torch.sqrt(torch.sum(window**2))
    p = (torch.abs(z) / wnorm) ** 2
    if db:
        return 10.0 * torch.log10(p + eps)
    return torch.log(p + eps)


def log_spectral_distance(
    input: torch.Tensor,
    target: torch.Tensor,
    p: float = 2,
    db: bool = True,
    n_fft: int = 400,
    hop_length: int = 160,
    eps: float = 1e-7,
    win_length: Optional[int] = None,
    scale_invariant: bool = False,
) -> torch.Tensor:
    """LSD between input and target; shapes [..., T] -> [...]."""
    if win_length is None:
        win_length = n_fft
    window = hann_window(n_fft, dtype=input.dtype, device=input.device)

    if scale_invariant:
        scaling = torch.sum(input * target, -1, keepdim=True) / (
            torch.sum(input**2, -1, keepdim=True) + eps)
    else:
        scaling = 1.0

    si = _log_power_spec(input, n_fft, hop_length, win_length, window, eps, db)
    st = _log_power_spec(scaling * target, n_fft, hop_length, win_length,
                         window, eps, db)
    denom = (st.shape[-1] * st.shape[-2]) ** (1.0 / p)
    diff = torch.abs(si - st) ** p
    return torch.sum(diff, dim=(-2, -1)) ** (1.0 / p) / denom
