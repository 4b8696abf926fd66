"""STFT / mel-spectrogram front-end (``torch.stft`` / torchaudio semantics:
periodic Hann window, one-sided rFFT, power spectrum, HTK mel scale with
``norm=None``).  Input is (batch..., time); output (batch..., frames, freqs).
``istft`` inverts ``stft`` by overlap-add (``torch.istft``'s semantics).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window, identical to torch.hann_window(n)."""
    k = np.arange(n)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)
    return torch.as_tensor(w, dtype=dtype, device=device)


def frame(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, frame_length), n_frames =
    (T - frame_length) // hop + 1 (torch.stft center=False)."""
    t = x.shape[-1]
    if (t - frame_length) // hop + 1 <= 0:
        raise ValueError(f"signal too short: T={t} < frame_length={frame_length}")
    return x.unfold(-1, frame_length, hop)


def stft(x: torch.Tensor, n_fft: int, hop: int,
         win_length: Optional[int] = None,
         window: Optional[torch.Tensor] = None, center: bool = False,
         pad_mode: str = "reflect") -> torch.Tensor:
    """One-sided complex STFT: (..., T) -> (..., n_frames, n_fft // 2 + 1).
    A window shorter than n_fft is zero-padded centred, as in torch."""
    if win_length is None:
        win_length = n_fft
    if window is None:
        window = hann_window(win_length, dtype=x.dtype, device=x.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    if center:
        pad = n_fft // 2
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode=pad_mode)
        x = x.reshape(*lead, x.shape[-1])
    frames = frame(x, n_fft, hop) * window.to(x.dtype)
    return torch.fft.rfft(frames, dim=-1)


def istft(z: torch.Tensor, n_fft: int, hop: int, length: Optional[int] = None,
          window: Optional[torch.Tensor] = None, center: bool = True) -> torch.Tensor:
    """Inverse STFT: complex (..., n_frames, n_fft // 2 + 1) -> (..., T), the
    windowed frames overlap-added and divided by the overlap-added squared
    window (floored at 1e-11).  With ``center`` the left n_fft // 2 samples
    go; ``length`` cuts (or zero-pads) the right end, else the symmetric
    n_fft // 2 goes too (JAX package ``ops/stft.py::istft``)."""
    if window is None:
        window = hann_window(n_fft, device=z.device)
    window = window.to(device=z.device, dtype=torch.float32)
    frames = torch.fft.irfft(z, n=n_fft, dim=-1) * window
    n_frames = frames.shape[-2]
    t_full = n_fft + hop * (n_frames - 1)
    lead = frames.shape[:-2]
    f2 = frames.reshape(-1, n_frames, n_fft).transpose(1, 2)  # (N, n_fft, frames)
    out = F.fold(f2, (1, t_full), (1, n_fft), stride=(1, hop)).reshape(-1, t_full)
    wsq = (window * window)[None, :, None].expand(1, n_fft, n_frames)
    wsum = F.fold(wsq, (1, t_full), (1, n_fft), stride=(1, hop)).reshape(t_full)
    out = out / torch.clamp(wsum, min=1e-11)
    if center:
        out = out[:, n_fft // 2:]
    if length is not None:
        if out.shape[-1] >= length:
            out = out[:, :length]
        else:
            out = F.pad(out, (0, length - out.shape[-1]))
    elif center:
        out = out[:, : t_full - 2 * (n_fft // 2)]
    return out.reshape(*lead, out.shape[-1])


def spectrogram(x: torch.Tensor, n_fft: int, hop: int,
                win_length: Optional[int] = None, power: float = 2.0,
                center: bool = False, pad_mode: str = "reflect") -> torch.Tensor:
    """Magnitude (power=1) or power (power=2) spectrogram."""
    z = stft(x, n_fft, hop, win_length=win_length, center=center,
             pad_mode=pad_mode)
    p2 = z.real * z.real + z.imag * z.imag
    if power == 2.0:
        return p2
    if power == 1.0:
        return torch.sqrt(torch.clamp(p2, min=0.0))
    return torch.pow(torch.clamp(p2, min=1e-30), power / 2.0)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@lru_cache(maxsize=32)
def _mel_fbank_np(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                  sample_rate: int) -> np.ndarray:
    """torchaudio.functional.melscale_fbanks(norm=None, mel_scale='htk'),
    (n_freqs, n_mels) float32."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max),
                        n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float = 0.0, f_max: Optional[float] = None,
                   device=None) -> torch.Tensor:
    if f_max is None:
        f_max = float(sample_rate // 2)
    fb = _mel_fbank_np(n_freqs, float(f_min), float(f_max), n_mels, sample_rate)
    return torch.tensor(fb, device=device)
