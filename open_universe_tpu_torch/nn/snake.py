"""Polyphase sinc resampling kernel (JAX package ``nn/snake.py``).

Only the numpy kernel design is here so far: ``data/audio.py`` resamples
with it.  The snake activations and the on-device resampler are not ported
yet.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

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
