"""UNIVERSE score network: conv U-Net over the raw waveform with a GRU
bottleneck (JAX package ``models/score.py``, unpacked execution)."""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import ConvBlock, PReLUConv
from ..nn.layers import GRU, Conv1d, Linear, PReLU
from ..nn.sigma import SigmaBlock, SimpleTimeEmbedding


class ScoreEncoder(nn.Module):
    def __init__(self, ds_factors, input_channels, noise_cond_dim,
                 with_gru_conv_sandwich=False, with_extra_conv_block=False,
                 act_type="prelu", use_weight_norm=False, seq_model="gru",
                 use_antialiasing=False):
        super().__init__()
        c = input_channels
        self.ds_modules = nn.ModuleList([
            ConvBlock(c * 2**i, r, "down", act_type=act_type,
                      weight_norm=use_weight_norm, antialiasing=use_antialiasing)
            for i, r in enumerate(ds_factors)
        ])
        self.cond_proj = nn.ModuleList([
            Linear(noise_cond_dim, c * 2 ** (i + 1), weight_norm=use_weight_norm)
            for i in range(len(ds_factors))
        ])
        oc = input_channels * 2 ** len(ds_factors)
        if with_extra_conv_block:
            self.ds_modules.append(
                ConvBlock(oc, act_type=act_type, weight_norm=use_weight_norm))
            self.cond_proj.append(
                Linear(noise_cond_dim, 2 * oc, weight_norm=use_weight_norm))

        self.seq_model = seq_model
        self.gru_conv_sandwich = False
        if seq_model == "gru":
            self.gru = GRU(oc, oc // 2, num_layers=1, bidirectional=True)
            self.gru_conv_sandwich = with_gru_conv_sandwich
            if with_gru_conv_sandwich:
                self.conv_block1 = ConvBlock(oc, act_type=act_type,
                                             weight_norm=use_weight_norm)
                self.conv_block2 = ConvBlock(oc, act_type=act_type,
                                             weight_norm=use_weight_norm)
        elif seq_model != "none":
            raise ValueError("seq_model must be gru|none")

    def forward(self, x: torch.Tensor, noise_cond: torch.Tensor):
        residuals: List[torch.Tensor] = []
        lengths: List[int] = []
        for ds, lin in zip(self.ds_modules, self.cond_proj):
            lengths.append(x.shape[1])
            x, res, _ = ds(x, noise_cond=lin(noise_cond))
            residuals.append(res)
        if self.seq_model == "gru":
            if self.gru_conv_sandwich:
                x = self.conv_block1(x)[0]
            x = self.gru(x)
            if self.gru_conv_sandwich:
                x = self.conv_block2(x)[0]
        return x, residuals[::-1], lengths[::-1]


class ScoreDecoder(nn.Module):
    def __init__(self, up_factors, input_channels, noise_cond_dim,
                 with_extra_conv_block=False, act_type="prelu",
                 use_weight_norm=False, use_antialiasing=False):
        super().__init__()
        n_channels = [input_channels * 2 ** (len(up_factors) - i - 1)
                      for i in range(len(up_factors))]
        self.up_modules = nn.ModuleList()
        self.noise_cond_proj = nn.ModuleList()
        self.signal_cond_proj = nn.ModuleList()
        if with_extra_conv_block:
            oc = input_channels * 2 ** len(up_factors)
            self.up_modules.append(
                ConvBlock(oc, act_type=act_type, weight_norm=use_weight_norm))
            self.noise_cond_proj.append(
                Linear(noise_cond_dim, 2 * oc, weight_norm=use_weight_norm))
            self.signal_cond_proj.append(
                Conv1d(oc, oc, 1, weight_norm=use_weight_norm))
        for c, r in zip(n_channels, up_factors):
            self.up_modules.append(
                ConvBlock(c, r, "up", act_type=act_type,
                          weight_norm=use_weight_norm,
                          antialiasing=use_antialiasing))
            self.noise_cond_proj.append(
                Linear(noise_cond_dim, 2 * c, weight_norm=use_weight_norm))
            self.signal_cond_proj.append(
                Conv1d(c, c, 1, weight_norm=use_weight_norm))

    def forward(self, x: torch.Tensor, noise_cond: torch.Tensor,
                input_cond: Sequence[torch.Tensor],
                residuals: Sequence[torch.Tensor],
                lengths: Sequence[int]) -> torch.Tensor:
        for up, ncp, scp, cond, res, length in zip(
                self.up_modules, self.noise_cond_proj, self.signal_cond_proj,
                input_cond, residuals, lengths):
            x = up(x, noise_cond=ncp(noise_cond), input_cond=scp(cond), res=res,
                   length=length)[0]
        return x


class ScoreNetwork(nn.Module):
    """Score network s(x_t, sigma | conditions)."""

    def __init__(self, fb_kernel_size=3, rate_factors=(2, 4, 4, 5), n_channels=32,
                 n_rff=32, noise_cond_dim=512, encoder_gru_conv_sandwich=False,
                 extra_conv_block=False, encoder_act_type="prelu",
                 decoder_act_type="prelu", precoding=None, input_channels=1,
                 output_channels=1, use_weight_norm=False, seq_model="gru",
                 use_antialiasing=False, time_embedding=None):
        super().__init__()
        if precoding is not None:
            raise NotImplementedError("precoding is not ported yet")
        if time_embedding == "simple":
            self.sigma_block = SimpleTimeEmbedding(n_dim=noise_cond_dim)
        else:
            self.sigma_block = SigmaBlock(n_rff, noise_cond_dim)
        self.input_channels = input_channels
        self.output_channels = output_channels
        self.rate_factors = list(rate_factors)
        self.n_channels = n_channels

        self.input_conv = Conv1d(input_channels, n_channels, fb_kernel_size,
                                 padding="same")
        self.encoder = ScoreEncoder(
            ds_factors=rate_factors, input_channels=n_channels,
            noise_cond_dim=noise_cond_dim,
            with_gru_conv_sandwich=encoder_gru_conv_sandwich,
            with_extra_conv_block=extra_conv_block,
            act_type=encoder_act_type, use_weight_norm=use_weight_norm,
            seq_model=seq_model, use_antialiasing=use_antialiasing)
        self.decoder = ScoreDecoder(
            up_factors=rate_factors[::-1], input_channels=n_channels,
            noise_cond_dim=noise_cond_dim,
            with_extra_conv_block=extra_conv_block,
            act_type=decoder_act_type, use_weight_norm=use_weight_norm,
            use_antialiasing=use_antialiasing)
        self.prelu = PReLU()
        self.output_conv = PReLUConv(n_channels, output_channels, fb_kernel_size,
                                     padding="same", weight_norm=use_weight_norm)

    def forward(self, x: torch.Tensor, sigma: torch.Tensor,
                cond: Sequence[torch.Tensor]) -> torch.Tensor:
        """x: (B, T, C), sigma: (B,), cond: per-stage tensors (coarse to fine)."""
        n_samples = x.shape[1]
        g = self.sigma_block(torch.log10(sigma))
        x = self.input_conv(x)
        h, residuals, lengths = self.encoder(x, g)
        s = self.decoder(h, g, cond, residuals, lengths)
        s = self.output_conv(self.prelu(s))
        if s.shape[1] < n_samples:
            s = F.pad(s, (0, 0, 0, n_samples - s.shape[1]))
        return s
