"""UNIVERSE conditioner network (JAX package ``models/condition.py``).

A U-Net over the noisy waveform that gives per-scale conditions, an
auxiliary clean-signal estimate and the bottleneck latent; a mel adapter and
per-level strided shortcut convs are summed into the bottleneck.

Reference quirks kept (published checkpoints depend on them): the
MelAdapter builds its filterbank as if the rate were 24 kHz, and the
encoder's anti-aliasing is forced off.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import ConvBlock, PReLUConv
from ..nn.layers import GRU, Conv1d
from ..ops.stft import mel_filterbank, spectrogram


def _st_conv_rates(ds_factors) -> List[int]:
    rates = [ds_factors[-1]]
    for r in ds_factors[-2::-1]:
        rates.append(rates[-1] * r)
    return rates[::-1]


class MelAdapter(nn.Module):
    """Mel front-end at the conditioner bottleneck: n_fft = oversample *
    ds_factor, hop = ds_factor, center=False with (n_fft - hop) / 2 padding,
    so the frame rate is the U-Net's latent rate."""

    CLAIMED_SAMPLE_RATE = 24000  # reference quirk, hardcoded

    def __init__(self, n_mels, output_channels, ds_factor, oversample=2,
                 weight_norm=False):
        super().__init__()
        self.n_mels = n_mels
        self.ds_factor = ds_factor
        self.n_fft = oversample * ds_factor
        pad_tot = self.n_fft - ds_factor
        self.pad_left, self.pad_right = pad_tot // 2, pad_tot - pad_tot // 2
        self.register_buffer(
            "fbank", mel_filterbank(self.n_fft // 2 + 1, n_mels,
                                    self.CLAIMED_SAMPLE_RATE), persistent=False)
        self.conv = Conv1d(n_mels, output_channels, 3, padding="same",
                           weight_norm=weight_norm)
        self.conv_block = ConvBlock(output_channels, weight_norm=weight_norm)

    def compute_mel_spec(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, C) -> (B, frames, n_mels) for C == 1, else
        (B, C, frames, n_mels); each channel is normalised to unit average
        frame energy.  The STFT runs in float32 or wider."""
        b, t, c = x.shape
        dtype = x.dtype
        xw = x.transpose(1, 2).reshape(b * c, t)
        if xw.dtype != torch.float64:
            xw = xw.float()
        r = t % self.ds_factor
        pad = self.ds_factor - r if r != 0 else 0
        xw = F.pad(xw, (self.pad_left, pad + self.pad_right))
        spec = spectrogram(xw, self.n_fft, self.ds_factor, power=2.0)
        mel = torch.matmul(spec, self.fbank.to(spec.dtype))
        norm = torch.sqrt(torch.mean(torch.sum(mel * mel, dim=-1, keepdim=True),
                                     dim=-2, keepdim=True))
        mel = (mel / torch.clamp(norm, min=1e-5)).to(dtype)
        if c == 1:
            return mel
        return mel.reshape(b, c, *mel.shape[1:])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.conv(self.compute_mel_spec(x))
        return self.conv_block(m)[0]


class ConditionerEncoder(nn.Module):
    def __init__(self, ds_factors, input_channels, with_gru_residual=False,
                 with_extra_conv_block=False, act_type="prelu",
                 use_weight_norm=False, seq_model="gru"):
        super().__init__()
        self.with_gru_residual = with_gru_residual
        c = input_channels
        self.ds_modules = nn.ModuleList([
            ConvBlock(c * 2**i, r, "down", act_type=act_type,
                      weight_norm=use_weight_norm)
            for i, r in enumerate(ds_factors)
        ])
        rates = _st_conv_rates(ds_factors)
        oc = input_channels * 2 ** len(ds_factors)
        # shortcut convs for every level but the last (None keeps indices)
        self.st_convs = nn.ModuleList([
            PReLUConv(c * 2**i, oc, rates[i], stride=rates[i],
                      weight_norm=use_weight_norm)
            for i in range(len(ds_factors) - 1)
        ])
        self.n_st = len(ds_factors) - 1
        if with_extra_conv_block:
            self.ds_modules.append(
                ConvBlock(oc, act_type=act_type, weight_norm=use_weight_norm))
        if seq_model != "gru":
            raise ValueError("seq_model must be gru")
        self.gru = GRU(oc, oc // 2, num_layers=2, bidirectional=True)
        self.conv_block1 = ConvBlock(oc, act_type=act_type,
                                     weight_norm=use_weight_norm)
        self.conv_block2 = ConvBlock(oc, act_type=act_type,
                                     weight_norm=use_weight_norm)

    def forward(self, x: torch.Tensor, x_mel: torch.Tensor):
        outputs = []
        lengths = []
        for i, ds in enumerate(self.ds_modules):
            lengths.append(x.shape[1])
            x, res, _ = ds(x)
            if i < self.n_st:
                outputs.append(self.st_convs[i](res))
        outputs.append(x)

        out = x_mel
        for o in outputs:
            out = out + o
        out = out * (1.0 / math.sqrt(len(outputs) + 1))

        out = self.conv_block1(out)[0]
        res = out
        out = self.gru(out)
        if self.with_gru_residual:
            out = (out + res) * (1.0 / math.sqrt(2.0))
        out = self.conv_block2(out)[0]
        return out, lengths[::-1]


class ConditionerDecoder(nn.Module):
    def __init__(self, up_factors, input_channels, with_extra_conv_block=False,
                 act_type="prelu", use_weight_norm=False, use_antialiasing=False):
        super().__init__()
        n_channels = [input_channels * 2 ** (len(up_factors) - i - 1)
                      for i in range(len(up_factors))]
        self.input_conv_block = ConvBlock(n_channels[0] * 2, act_type=act_type,
                                          weight_norm=use_weight_norm)
        ups = [ConvBlock(c, r, "up", act_type=act_type,
                         weight_norm=use_weight_norm,
                         antialiasing=use_antialiasing)
               for c, r in zip(n_channels, up_factors)]
        if with_extra_conv_block:
            ups = [ConvBlock(2 * n_channels[0], act_type=act_type,
                             weight_norm=use_weight_norm)] + ups
        self.up_modules = nn.ModuleList(ups)

    def forward(self, x: torch.Tensor, lengths):
        conditions = []
        x = self.input_conv_block(x)[0]
        for up, length in zip(self.up_modules, lengths):
            x, _, cond = up(x, length=length)
            conditions.append(cond)
        return x, conditions


class ConditionerNetwork(nn.Module):
    def __init__(self, fb_kernel_size=3, rate_factors=(2, 4, 4, 5), n_channels=32,
                 n_mels=80, n_mel_oversample=4, encoder_gru_residual=False,
                 extra_conv_block=False, encoder_act_type="prelu",
                 decoder_act_type="prelu", precoding=None, input_channels=1,
                 output_channels=None, use_weight_norm=False, seq_model="gru",
                 use_antialiasing=False):
        super().__init__()
        if precoding is not None:
            raise NotImplementedError("precoding is not ported yet")
        self.n_mels = n_mels
        self.input_channels = input_channels
        self.rate_factors = list(rate_factors)
        self.n_channels = n_channels

        self.input_conv = Conv1d(input_channels, n_channels, fb_kernel_size,
                                 padding="same", weight_norm=use_weight_norm)
        if output_channels is not None:
            self.output_conv = Conv1d(n_channels, output_channels, fb_kernel_size,
                                      padding="same", weight_norm=use_weight_norm)
        else:
            self.output_conv = None

        total_ds = math.prod(rate_factors)
        total_channels = 2 ** len(rate_factors) * n_channels
        self.input_mel = MelAdapter(n_mels, total_channels,
                                    total_ds * input_channels, n_mel_oversample,
                                    weight_norm=use_weight_norm)
        # reference quirk: the encoder's anti-aliasing is forced off
        self.encoder = ConditionerEncoder(
            rate_factors, n_channels, with_gru_residual=encoder_gru_residual,
            with_extra_conv_block=extra_conv_block, act_type=encoder_act_type,
            use_weight_norm=use_weight_norm, seq_model=seq_model)
        self.decoder = ConditionerDecoder(
            rate_factors[::-1], n_channels, with_extra_conv_block=extra_conv_block,
            act_type=decoder_act_type, use_weight_norm=use_weight_norm,
            use_antialiasing=use_antialiasing)

    def forward(self, x: torch.Tensor, x_wav: Optional[torch.Tensor] = None):
        """x: (B, T, C) -> (conditions, y_hat (B, T, n_channels), latent h)."""
        n_samples = x.shape[1]
        if x_wav is None:
            x_wav = x
        x_mel = self.input_mel(x_wav)
        h, lengths = self.encoder(self.input_conv(x), x_mel)
        y_hat, conditions = self.decoder(h, lengths)
        if self.output_conv is not None:
            y_hat = self.output_conv(y_hat)
        if y_hat.shape[1] < n_samples:
            y_hat = F.pad(y_hat, (0, 0, 0, n_samples - y_hat.shape[1]))
        return conditions, y_hat, h
