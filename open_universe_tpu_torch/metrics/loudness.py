"""ITU-R BS.1770-4 integrated loudness (LKFS), numpy implementation (the
port's copy of the JAX package's ``metrics/loudness.py``).

Fills the role of torchaudio.functional.loudness (loudness-matched
validation audio logging, reference universe.py:662-704) but follows the
BS.1770 spec EXACTLY: K-weighting = high-shelf (+4 dB at 1681.97 Hz,
Q 0.70718) + high-pass (38.135 Hz, Q 0.50033) — the design frequencies whose
48 kHz biquad coefficients the spec tabulates.  torchaudio approximates
these with 1500 Hz / Q 1/sqrt(2) and 38.0 Hz / Q 0.5, a spectrum-dependent
deviation of up to ~0.2 dB; since the value is only used for gain-matching
TB audio, we keep the spec-exact filters (deliberate divergence).  Then
400 ms blocks with 75% overlap and two-stage gating (-70 LKFS absolute,
relative mean - 10).
"""
from __future__ import annotations

import math

import numpy as np
from scipy.signal import lfilter


def _treble_biquad(fs: float, gain_db=4.0, fc=1681.9744509555319, q=0.7071752369554196):
    a = 10.0 ** (gain_db / 40.0)
    w0 = 2 * math.pi * fc / fs
    alpha = math.sin(w0) / (2 * q)
    cos = math.cos(w0)
    b0 = a * ((a + 1) + (a - 1) * cos + 2 * math.sqrt(a) * alpha)
    b1 = -2 * a * ((a - 1) + (a + 1) * cos)
    b2 = a * ((a + 1) + (a - 1) * cos - 2 * math.sqrt(a) * alpha)
    a0 = (a + 1) - (a - 1) * cos + 2 * math.sqrt(a) * alpha
    a1 = 2 * ((a - 1) - (a + 1) * cos)
    a2 = (a + 1) - (a - 1) * cos - 2 * math.sqrt(a) * alpha
    return np.array([b0, b1, b2]) / a0, np.array([1.0, a1 / a0, a2 / a0])


def _highpass_biquad(fs: float, fc=38.13547087602444, q=0.5003270373238773):
    w0 = 2 * math.pi * fc / fs
    alpha = math.sin(w0) / (2 * q)
    cos = math.cos(w0)
    b0 = (1 + cos) / 2
    b1 = -(1 + cos)
    b2 = (1 + cos) / 2
    a0 = 1 + alpha
    a1 = -2 * cos
    a2 = 1 - alpha
    return np.array([b0, b1, b2]) / a0, np.array([1.0, a1 / a0, a2 / a0])


def loudness(waveform: np.ndarray, sample_rate: int) -> float:
    """waveform: (channels, T) or (T,) -> integrated loudness in LKFS."""
    x = np.asarray(waveform, np.float64)
    if x.ndim == 1:
        x = x[None, :]
    b1, a1 = _treble_biquad(sample_rate)
    b2, a2 = _highpass_biquad(sample_rate)
    y = lfilter(b2, a2, lfilter(b1, a1, x, axis=-1), axis=-1)

    block = int(round(0.4 * sample_rate))
    hop = int(round(0.1 * sample_rate))
    t = y.shape[-1]
    if t < block:
        return float("-inf")
    n_blocks = (t - block) // hop + 1
    idx = np.arange(block)[None, :] + hop * np.arange(n_blocks)[:, None]
    frames = y[:, idx]  # (C, n_blocks, block)
    z = np.mean(frames**2, axis=-1)  # (C, n_blocks)
    # channel weights: 1.0 for the first 3 channels, 1.41 for surrounds
    g = np.ones(y.shape[0])
    if y.shape[0] > 3:
        g[3:] = 1.41
    power = np.sum(g[:, None] * z, axis=0)  # (n_blocks,)
    lk = -0.691 + 10.0 * np.log10(np.maximum(power, 1e-12))

    gate_abs = lk > -70.0
    if not gate_abs.any():
        return float("-inf")
    rel_thresh = (-0.691 + 10.0 * np.log10(np.mean(power[gate_abs]))) - 10.0
    gate = gate_abs & (lk > rel_thresh)
    if not gate.any():
        return float("-inf")
    return float(-0.691 + 10.0 * np.log10(np.mean(power[gate])))
