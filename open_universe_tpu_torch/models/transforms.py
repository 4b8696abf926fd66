"""Waveform transforms for the UNIVERSE models and their networks'
``precoding`` (JAX package ``models/transforms.py``, reference
layers/dyn_range_comp.py).

``IdentityTransform`` (the default) and ``CompressedMagSTFT``, which maps a
waveform (B, T, 1) to a magnitude-compressed complex spectrogram packed as
real channels, (B, frames, 2 * n_freq): the real parts, then the imaginary
ones.  ``inv=True`` runs it backwards (overlap-add ``istft``).
``CompressedMagSTFTPadded`` pads the waveform to a multiple of
``pad_block`` and cuts a hop off its end before the STFT.  None has
parameters.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.stft import hann_window, istft, stft


class IdentityTransform(nn.Module):
    """The identity waveform transform."""

    def forward(self, x: torch.Tensor, inv: bool = False,
                length: Optional[int] = None) -> torch.Tensor:
        return x

    def inv(self, x: torch.Tensor, length: Optional[int] = None) -> torch.Tensor:
        return x


def get_window(window_type: str, n: int) -> torch.Tensor:
    if window_type == "sqrthann":
        return torch.sqrt(hann_window(n))
    if window_type == "hann":
        return hann_window(n)
    if window_type == "hamming":
        k = torch.arange(n, dtype=torch.float32)
        return 0.54 - 0.46 * torch.cos(2.0 * math.pi * k / n)
    raise NotImplementedError(f"window {window_type!r} not implemented")


class CompressedMagSTFT(nn.Module):
    def __init__(self, stft_kwargs: dict, spec_kwargs: dict, inv: bool = False):
        super().__init__()
        assert all(k in stft_kwargs for k in ("n_fft", "hop_length", "window_name"))
        assert all(k in spec_kwargs for k in ("transform_type", "abs_exponent", "factor"))
        self.n_fft = stft_kwargs["n_fft"]
        self.hop = stft_kwargs["hop_length"]
        self.register_buffer("window", get_window(stft_kwargs.get("window_name", "hann"),
                                                  self.n_fft), persistent=False)
        self.spec_kwargs = dict(spec_kwargs)
        self._inv = inv

    def _forward_transform(self, spec: torch.Tensor) -> torch.Tensor:
        tt = self.spec_kwargs["transform_type"]
        if tt == "exponent":
            e = self.spec_kwargs["abs_exponent"]
            if e != 1:
                spec = (1e-7 + torch.abs(spec)) ** (e - 1.0) * spec
            return spec * self.spec_kwargs["factor"]
        if tt == "log":
            sgn = spec / torch.clamp(torch.abs(spec), min=1e-30)
            return torch.log(1.0 + torch.abs(spec)) * sgn * self.spec_kwargs["factor"]
        return spec

    def _backward_transform(self, spec: torch.Tensor) -> torch.Tensor:
        tt = self.spec_kwargs["transform_type"]
        if tt == "exponent":
            spec = spec / self.spec_kwargs["factor"]
            e = self.spec_kwargs["abs_exponent"]
            if e != 1:
                spec = (1e-7 + torch.abs(spec)) ** (1.0 / e - 1.0) * spec
            return spec
        if tt == "log":
            spec = spec / self.spec_kwargs["factor"]
            sgn = spec / torch.clamp(torch.abs(spec), min=1e-30)
            return (torch.exp(torch.abs(spec)) - 1.0) * sgn
        return spec

    def _stft(self, sig: torch.Tensor) -> torch.Tensor:
        return stft(sig, self.n_fft, self.hop, window=self.window, center=True,
                    pad_mode="constant")

    def _istft(self, spec: torch.Tensor, length: Optional[int] = None) -> torch.Tensor:
        return istft(spec, self.n_fft, self.hop, length=length, window=self.window,
                     center=True)

    def forward(self, x: torch.Tensor, inv: bool = False,
                length: Optional[int] = None) -> torch.Tensor:
        """(B, T, 1) -> (B, frames, 2 n_freq); with ``inv`` the way back,
        cut to ``length`` samples when given.  The FFTs run in float32; the
        result has the input's dtype."""
        if self._inv:
            inv = not inv
        if not inv:
            if x.shape[-1] != 1:
                raise ValueError("expects single-channel input (B, T, 1)")
            z = self._forward_transform(self._stft(x[..., 0].float()))
            return torch.cat([z.real, z.imag], dim=-1).to(x.dtype)
        n_freq = x.shape[-1] // 2
        z = torch.complex(x[..., :n_freq].float(), x[..., n_freq:].float())
        y = self._istft(self._backward_transform(z), length=length)
        return y[..., None].to(x.dtype)

    def inv(self, x: torch.Tensor, length: Optional[int] = None) -> torch.Tensor:
        return self(x, inv=True, length=length)


class CompressedMagSTFTPadded(CompressedMagSTFT):
    def __init__(self, stft_kwargs: dict, spec_kwargs: dict,
                 pad_block: Optional[int] = None, inv: bool = False):
        super().__init__(stft_kwargs, spec_kwargs, inv=inv)
        if pad_block is not None and pad_block % self.hop != 0:
            raise ValueError("pad_block must be a multiple of hop_length")
        self.pad_block = pad_block or 0

    def _pad(self, sig: torch.Tensor) -> torch.Tensor:
        if self.pad_block > 0:
            r = sig.shape[-1] % self.pad_block
            if r > 0:
                sig = F.pad(sig, (0, self.pad_block - r))
        return sig[..., : -self.hop]

    def _stft(self, sig: torch.Tensor) -> torch.Tensor:
        # the reference pads twice (dyn_range_comp.py:199-200), and so do we
        return super()._stft(self._pad(self._pad(sig)))

    def _istft(self, spec: torch.Tensor, length: Optional[int] = None) -> torch.Tensor:
        if length is None:
            length = spec.shape[-2] * self.hop
        return super()._istft(spec, length=length)
