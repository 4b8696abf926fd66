"""Multi-period and multi-resolution discriminators and the LSGAN losses
(JAX package ``models/discriminators.py``; reference BigVGAN ``gan.py``).

Feature maps are NCHW where JAX's are NHWC: a period discriminator folds the
waveform to (B, C, T/p, p), a resolution discriminator takes the STFT
magnitude as (B, C, freq, frames).  The scores flatten the same (H, W) grid
in the same order, and the losses are means, so both sides compute the same
numbers.  ``use_spectral_norm`` / ``mrd_use_spectral_norm`` swap weight norm
for spectral norm as the reference does.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Conv2d
from ..ops.stft import stft

LRELU_SLOPE = 0.1


def _get_padding(kernel_size, dilation=1):
    return int((kernel_size * dilation - dilation) / 2)


class DiscriminatorP(nn.Module):
    """Period discriminator: 2-D convs over the period-folded waveform."""

    def __init__(self, cfg: dict, period: int, kernel_size=5, stride=3):
        super().__init__()
        self.period = period
        d_mult = cfg.get("discriminator_channel_mult", 1)
        in_ch = cfg.get("input_channels", 1)
        sn = bool(cfg.get("use_spectral_norm", False))
        norm = dict(weight_norm=not sn, spectral_norm=sn)
        chans = [in_ch, int(32 * d_mult), int(128 * d_mult), int(512 * d_mult),
                 int(1024 * d_mult)]
        convs = [Conv2d(chans[i], chans[i + 1], (kernel_size, 1), stride=(stride, 1),
                        padding=(_get_padding(5, 1), 0), **norm) for i in range(4)]
        convs.append(Conv2d(chans[4], int(1024 * d_mult), (kernel_size, 1),
                            stride=(1, 1), padding=(2, 0), **norm))
        self.convs = nn.ModuleList(convs)
        self.conv_post = Conv2d(int(1024 * d_mult), 1, (3, 1), padding=(1, 0), **norm)

    def forward(self, x: torch.Tensor):
        """x: (B, T, C) -> (score (B, S), feature maps)."""
        b, t, c = x.shape
        x = x.transpose(1, 2)
        if t % self.period != 0:
            n_pad = self.period - (t % self.period)
            x = F.pad(x, (0, n_pad), mode="reflect")
            t = t + n_pad
        x = x.reshape(b, c, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class DiscriminatorR(nn.Module):
    """Resolution discriminator: 2-D convs over an STFT magnitude."""

    def __init__(self, cfg: dict, resolution: Sequence[int]):
        super().__init__()
        if len(resolution) != 3:
            raise ValueError(f"a resolution is (n_fft, hop, win), got {resolution}")
        self.resolution = list(resolution)
        d_mult = cfg.get("mrd_channel_mult", cfg.get("discriminator_channel_mult", 1))
        in_ch = cfg.get("input_channels", 1)
        sn = bool(cfg.get("mrd_use_spectral_norm", cfg.get("use_spectral_norm", False)))
        norm = dict(weight_norm=not sn, spectral_norm=sn)
        c = int(32 * d_mult)
        self.convs = nn.ModuleList([
            Conv2d(in_ch, c, (3, 9), padding=(1, 4), **norm),
            Conv2d(c, c, (3, 9), stride=(1, 2), padding=(1, 4), **norm),
            Conv2d(c, c, (3, 9), stride=(1, 2), padding=(1, 4), **norm),
            Conv2d(c, c, (3, 9), stride=(1, 2), padding=(1, 4), **norm),
            Conv2d(c, c, (3, 3), padding=(1, 1), **norm),
        ])
        self.conv_post = Conv2d(c, 1, (3, 3), padding=(1, 1), **norm)

    def spectrogram(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, C) -> magnitude (B, C, freq, frames), the STFT in
        float32.  The reference passes torch.stft no window: a rectangular
        window of win_length, zero-padded to n_fft."""
        n_fft, hop, win = self.resolution
        pad = int((n_fft - hop) / 2)
        xw = F.pad(x.transpose(1, 2).float(), (pad, pad), mode="reflect")
        z = stft(xw, n_fft, hop, win_length=win, center=False,
                 window=torch.ones(win, device=x.device))
        return torch.abs(z).to(x.dtype).transpose(-1, -2)

    def forward(self, x: torch.Tensor):
        h = self.spectrogram(x)
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(h.shape[0], -1), fmap


def paired_apply(disc: nn.Module, y: torch.Tensor, y_hat: torch.Tensor):
    """One discriminator on real and fake stacked along the batch: one pass
    at 2B, equal to two at B (the convs are batch-parallel)."""
    b = y.shape[0]
    s, f = disc(torch.cat([y, y_hat], dim=0))
    return s[:b], s[b:], [h[:b] for h in f], [h[b:] for h in f]


class _MultiDiscriminator(nn.Module):
    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """-> (real scores, fake scores, real fmaps, fake fmaps), one entry
        per sub-discriminator."""
        out = ([], [], [], [])
        for d in self.discriminators:
            for acc, v in zip(out, paired_apply(d, y, y_hat)):
                acc.append(v)
        return out


class MultiPeriodDiscriminator(_MultiDiscriminator):
    def __init__(self, cfg: dict):
        super().__init__()
        self.periods = list(cfg.get("mpd_reshapes", [2, 3, 5, 7, 11]))
        self.discriminators = nn.ModuleList([DiscriminatorP(cfg, p) for p in self.periods])


class MultiResolutionDiscriminator(_MultiDiscriminator):
    def __init__(self, cfg: dict):
        super().__init__()
        resolutions = cfg.get(
            "resolutions", [[1024, 120, 600], [2048, 240, 1200], [512, 50, 240]])
        if len(resolutions) != 3:
            raise ValueError(f"MRD takes three resolutions, got {resolutions}")
        self.discriminators = nn.ModuleList([DiscriminatorR(cfg, r) for r in resolutions])


# ----------------------------------------------------------- LSGAN losses
def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2.0


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    loss, r_losses, g_losses = 0.0, [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1.0 - dr) ** 2)
        g_loss = torch.mean(dg ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    loss, gen_losses = 0.0, []
    for dg in disc_outputs:
        l = torch.mean((1.0 - dg) ** 2)
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses
