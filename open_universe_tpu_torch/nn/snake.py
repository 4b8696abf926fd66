"""Snake periodic activations applied anti-aliased, and the polyphase sinc
resampler they need (JAX package ``nn/snake.py``; reference
networks/bigvgan/snake.py, alias_free_act.py).

``Snake``/SnakeBeta have a per-channel trainable frequency (optionally
log-scale); ``AliasFreeSnake`` sandwiches one between a 2x upsample and a
2x downsample.  The resampling kernel is torchaudio's ``sinc_interp_hann``
design (lowpass_filter_width=6, rolloff=0.99), so converted checkpoints
behave the same; ``data/audio.py`` resamples files on the host with the same
numpy kernel.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_LOWPASS_WIDTH = 6
_ROLLOFF = 0.99


@lru_cache(maxsize=8)
def _sinc_kernel_np(orig: int, new: int) -> tuple:
    """torchaudio ``_get_sinc_resample_kernel`` (hann window).  Returns
    (kernel, width, orig, new) with orig/new reduced by their gcd and kernel
    of shape (new, taps): one polyphase filter per output phase."""
    g = math.gcd(orig, new)
    orig, new = orig // g, new // g
    base_freq = min(orig, new) * _ROLLOFF
    width = math.ceil(_LOWPASS_WIDTH * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = t * base_freq
    t = np.clip(t, -_LOWPASS_WIDTH, _LOWPASS_WIDTH)
    window = np.cos(t * np.pi / _LOWPASS_WIDTH / 2) ** 2
    t = t * np.pi
    scale = base_freq / orig
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * scale
    return kernel.astype(np.float32), width, orig, new


def resample(x: torch.Tensor, orig: int, new: int) -> torch.Tensor:
    """Polyphase sinc resample along the time axis; x: (B, T, C).  Channels
    are folded into the batch and filtered alike by one strided conv."""
    kernel_np, width, orig, new = _sinc_kernel_np(orig, new)
    if orig == new:
        return x
    b, t, c = x.shape
    xf = x.transpose(1, 2).reshape(b * c, 1, t)
    xf = F.pad(xf, (width, width + orig))
    w = torch.as_tensor(kernel_np, dtype=x.dtype, device=x.device)[:, None, :]
    y = F.conv1d(xf, w, stride=orig)  # (B*C, new, frames)
    y = y.transpose(1, 2).reshape(b * c, -1)
    target = int(math.ceil(new * t / orig))
    return y[:, :target].reshape(b, c, target).transpose(1, 2)


class Snake(nn.Module):
    """snake(x) = x + sin^2(alpha x) / beta, per channel; beta is alpha
    unless ``beta`` (SnakeBeta), both exp'd with ``alpha_logscale``."""

    def __init__(self, channels: int, alpha: float = 1.0,
                 alpha_logscale: bool = False, beta: bool = False):
        super().__init__()
        self.alpha_logscale = alpha_logscale
        self.eps = 1e-9
        fill = 0.0 if alpha_logscale else alpha
        self.alpha = nn.Parameter(torch.full((channels,), fill))
        if beta:
            self.beta = nn.Parameter(torch.full((channels,), fill))
        else:
            self.register_parameter("beta", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.to(x.dtype)
        beta = alpha if self.beta is None else self.beta.to(x.dtype)
        if self.alpha_logscale:
            alpha = torch.exp(alpha)
            beta = torch.exp(beta)
        s = torch.sin(x * alpha)
        return x + s * s / (beta + self.eps)


class Activation1d(nn.Module):
    """up_ratio x upsample -> activation -> down_ratio x downsample."""

    def __init__(self, activation: nn.Module, up_ratio: int = 2,
                 down_ratio: int = 2):
        super().__init__()
        self.up_ratio = up_ratio
        self.down_ratio = down_ratio
        self.act = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = resample(x, 1, self.up_ratio)
        return resample(self.act(y), self.down_ratio, 1)


class AliasFreeSnake(nn.Module):
    """2x upsample -> snake -> 2x downsample (BigVGAN Activation1d).  The
    nesting (``act.act.alpha``) matches the reference ``state_dict``."""

    def __init__(self, channels: int, alpha: float = 1.0,
                 alpha_logscale: bool = False, beta: bool = False,
                 up_ratio: int = 2, down_ratio: int = 2):
        super().__init__()
        self.act = Activation1d(
            Snake(channels, alpha=alpha, alpha_logscale=alpha_logscale, beta=beta),
            up_ratio=up_ratio, down_ratio=down_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(x)
