"""Plain PyTorch reference of UNIVERSE (arXiv:2206.03065) and UNIVERSE++
(arXiv:2406.12194) inference: the score and conditioner networks and the
8-step sampler, as line/open-universe publishes them (``networks/universe``,
``config/model/default.yaml``, ``universe_original.yaml``).

``Reference(cfg)`` builds the networks from a configuration file's
``model`` node.  ``enhance(mix, draws)`` runs normalisation, the conditioner,
the sampler (EDM for UNIVERSE++, the plain score path for UNIVERSE), the
unpadding and the clip protection on a (B, T) float32 batch, with the
sampler's normal draws given.  The networks follow the published quirks: the
mel adapter's filterbank is built as if the rate were 24 kHz, and the
conditioner's encoder has no anti-aliasing.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import GRU, ConvBlock, Conv1d, Linear, PReLU, PReLUConv

MEL_CLAIMED_RATE = 24000


class LinearPReLU(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.prelu = PReLU()
        self.lin = Linear(cin, cout)

    def forward(self, x):
        return self.prelu(self.lin(x))


class SigmaBlock(nn.Module):
    """Random Fourier features of log10(sigma) (``freq``, a loaded buffer)
    through three Linear-PReLU layers."""

    def __init__(self, n_rff, n_dim):
        super().__init__()
        self.register_buffer("freq", torch.empty(n_rff))
        self.layer1 = LinearPReLU(2 * n_rff, 4 * n_rff)
        self.layer2 = LinearPReLU(4 * n_rff, 8 * n_rff)
        self.layer3 = LinearPReLU(8 * n_rff, n_dim)

    def forward(self, log_sigma):
        p = 2.0 * math.pi * self.freq[None, :] * log_sigma[:, None]
        return self.layer3(self.layer2(self.layer1(torch.cat([torch.sin(p), torch.cos(p)], -1))))


class SimpleTimeEmbedding(nn.Module):
    """A sinusoid with a learned continuous frequency (UNIVERSE++)."""

    def __init__(self, n_dim):
        super().__init__()
        self.n_dim = n_dim
        self.weight = nn.Parameter(torch.empty(1, 1))
        self.bias = nn.Parameter(torch.empty(1, 1))

    def forward(self, log_sigma):
        t = torch.arange(self.n_dim // 2, dtype=log_sigma.dtype, device=log_sigma.device)
        f = 0.5 * torch.sigmoid(self.weight * log_sigma[:, None] + self.bias)
        p = 2.0 * math.pi * f * t
        return torch.cat([torch.sin(p), torch.cos(p)], -1)


def mel_fbank(n_freqs, n_mels, rate):
    """HTK mel filterbank, no normalisation (torchaudio's melscale_fbanks)."""
    hz_to_mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)  # noqa: E731
    m = np.linspace(hz_to_mel(0.0), hz_to_mel(rate // 2), n_mels + 2)
    f_pts = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    freqs = np.linspace(0, rate // 2, n_freqs)
    diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[:-1], slopes[:, 2:] / diff[1:]))
    return torch.from_numpy(fb.astype(np.float32))


class MelAdapter(nn.Module):
    def __init__(self, n_mels, cout, ds, oversample, weight_norm):
        super().__init__()
        self.ds, self.n_fft = ds, oversample * ds
        pad = self.n_fft - ds
        self.pads = (pad // 2, pad - pad // 2)
        self.register_buffer("fbank", mel_fbank(self.n_fft // 2 + 1, n_mels, MEL_CLAIMED_RATE),
                             persistent=False)
        self.conv = Conv1d(n_mels, cout, 3, padding="same", weight_norm=weight_norm)
        self.conv_block = ConvBlock(cout, weight_norm=weight_norm)

    def forward(self, x):
        xw = x[..., 0]
        r = xw.shape[1] % self.ds
        xw = F.pad(xw, (self.pads[0], (self.ds - r if r else 0) + self.pads[1]))
        k = torch.arange(self.n_fft, dtype=xw.dtype, device=xw.device)
        window = 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / self.n_fft)
        spec = torch.fft.rfft(xw.unfold(-1, self.n_fft, self.ds) * window, dim=-1)
        mel = (spec.real ** 2 + spec.imag ** 2) @ self.fbank
        norm = torch.sqrt(torch.mean(torch.sum(mel * mel, -1, keepdim=True), -2, keepdim=True))
        return self.conv_block(self.conv(mel / torch.clamp(norm, min=1e-5)))[0]


class ScoreNetwork(nn.Module):
    def __init__(self, rate_factors, n_channels, n_rff, noise_cond_dim, extra_conv_block,
                 use_weight_norm, use_antialiasing, time_embedding=None, fb_kernel_size=3,
                 seq_model="gru", encoder_gru_conv_sandwich=False, decoder_act_type="prelu",
                 **unused):
        super().__init__()
        if seq_model != "gru" or encoder_gru_conv_sandwich or decoder_act_type != "prelu":
            raise ValueError("the reference has the published GRU U-Net only")
        wn, aa, c, n = use_weight_norm, use_antialiasing, n_channels, len(rate_factors)
        self.sigma_block = (SimpleTimeEmbedding(noise_cond_dim) if time_embedding == "simple"
                            else SigmaBlock(n_rff, noise_cond_dim))
        self.input_conv = Conv1d(1, c, fb_kernel_size, padding="same")
        oc = c * 2 ** n
        enc = nn.Module()
        enc.ds_modules = nn.ModuleList([ConvBlock(c * 2 ** i, r, "down", wn, aa)
                                        for i, r in enumerate(rate_factors)])
        enc.cond_proj = nn.ModuleList([Linear(noise_cond_dim, c * 2 ** (i + 1), weight_norm=wn)
                                       for i in range(n)])
        dec = nn.Module()
        dec.up_modules, dec.noise_cond_proj, dec.signal_cond_proj = (
            nn.ModuleList(), nn.ModuleList(), nn.ModuleList())
        if extra_conv_block:
            enc.ds_modules.append(ConvBlock(oc, weight_norm=wn))
            enc.cond_proj.append(Linear(noise_cond_dim, 2 * oc, weight_norm=wn))
            dec.up_modules.append(ConvBlock(oc, weight_norm=wn))
            dec.noise_cond_proj.append(Linear(noise_cond_dim, 2 * oc, weight_norm=wn))
            dec.signal_cond_proj.append(Conv1d(oc, oc, 1, weight_norm=wn))
        enc.gru = GRU(oc, oc // 2, 1)
        for i, r in enumerate(rate_factors[::-1]):
            ci = c * 2 ** (n - i - 1)
            dec.up_modules.append(ConvBlock(ci, r, "up", wn, aa))
            dec.noise_cond_proj.append(Linear(noise_cond_dim, 2 * ci, weight_norm=wn))
            dec.signal_cond_proj.append(Conv1d(ci, ci, 1, weight_norm=wn))
        self.encoder, self.decoder = enc, dec
        self.prelu = PReLU()
        self.output_conv = PReLUConv(c, 1, fb_kernel_size, padding="same", weight_norm=wn)

    def forward(self, x, sigma, cond):
        n_samples = x.shape[1]
        g = self.sigma_block(torch.log10(sigma))
        x = self.input_conv(x)
        residuals, lengths = [], []
        for ds, lin in zip(self.encoder.ds_modules, self.encoder.cond_proj):
            lengths.append(x.shape[1])
            x, res, _ = ds(x, noise_cond=lin(g))
            residuals.append(res)
        x = self.encoder.gru(x)
        d = self.decoder
        for up, ncp, scp, c, res, length in zip(d.up_modules, d.noise_cond_proj,
                                                d.signal_cond_proj, cond, residuals[::-1],
                                                lengths[::-1]):
            x = up(x, noise_cond=ncp(g), input_cond=scp(c), res=res, length=length)[0]
        s = self.output_conv(self.prelu(x))
        return F.pad(s, (0, 0, 0, n_samples - s.shape[1])) if s.shape[1] < n_samples else s


class ConditionerNetwork(nn.Module):
    def __init__(self, rate_factors, n_channels, n_mels, n_mel_oversample, encoder_gru_residual,
                 extra_conv_block, use_weight_norm, fb_kernel_size=3, use_antialiasing=False,
                 output_channels=None, seq_model="gru", decoder_act_type="prelu", **unused):
        super().__init__()
        if output_channels is not None or seq_model != "gru" or decoder_act_type != "prelu":
            raise ValueError("the reference has the published conditioner only")
        wn, c, n = use_weight_norm, n_channels, len(rate_factors)
        oc = c * 2 ** n
        self.gru_residual = encoder_gru_residual
        self.input_conv = Conv1d(1, c, fb_kernel_size, padding="same", weight_norm=wn)
        self.input_mel = MelAdapter(n_mels, oc, math.prod(rate_factors), n_mel_oversample, wn)
        rates = [rate_factors[-1]]
        for r in rate_factors[-2::-1]:
            rates.append(rates[-1] * r)
        rates = rates[::-1]
        enc = nn.Module()
        enc.ds_modules = nn.ModuleList([ConvBlock(c * 2 ** i, r, "down", wn)
                                        for i, r in enumerate(rate_factors)])
        enc.st_convs = nn.ModuleList([PReLUConv(c * 2 ** i, oc, rates[i], stride=rates[i],
                                                weight_norm=wn) for i in range(n - 1)])
        if extra_conv_block:
            enc.ds_modules.append(ConvBlock(oc, weight_norm=wn))
        enc.gru = GRU(oc, oc // 2, 2)
        enc.conv_block1 = ConvBlock(oc, weight_norm=wn)
        enc.conv_block2 = ConvBlock(oc, weight_norm=wn)
        dec = nn.Module()
        widths = [c * 2 ** (n - i - 1) for i in range(n)]
        dec.input_conv_block = ConvBlock(2 * widths[0], weight_norm=wn)
        ups = [ConvBlock(ci, r, "up", wn, use_antialiasing)
               for ci, r in zip(widths, rate_factors[::-1])]
        if extra_conv_block:
            ups = [ConvBlock(2 * widths[0], weight_norm=wn)] + ups
        dec.up_modules = nn.ModuleList(ups)
        self.encoder, self.decoder, self.n_st = enc, dec, n - 1

    def forward(self, x):
        x_mel = self.input_mel(x)
        x = self.input_conv(x)
        enc, outputs, lengths = self.encoder, [], []
        for i, ds in enumerate(enc.ds_modules):
            lengths.append(x.shape[1])
            x, res, _ = ds(x)
            if i < self.n_st:
                outputs.append(enc.st_convs[i](res))
        outputs.append(x)
        out = x_mel
        for o in outputs:
            out = out + o
        out = enc.conv_block1(out * (1.0 / math.sqrt(len(outputs) + 1)))[0]
        res = out
        out = enc.gru(out)
        if self.gru_residual:
            out = (out + res) * (1.0 / math.sqrt(2.0))
        x = self.decoder.input_conv_block(enc.conv_block2(out)[0])[0]
        conditions = []
        for up, length in zip(self.decoder.up_modules, lengths[::-1]):
            x, _, cond = up(x, length=length)
            conditions.append(cond)
        return conditions


class Reference(nn.Module):
    """The published model's inference.  ``weight_norm=False`` builds the
    folded layout that ``enhance`` runs; ``True`` the checkpoint's layout."""

    def __init__(self, cfg: dict, weight_norm: bool = False):
        super().__init__()
        sm, cm = dict(cfg["score_model"]), dict(cfg["condition_model"])
        for k, v in cm.items():
            if isinstance(v, str) and v.startswith("${model.score_model."):
                cm[k] = sm[v[len("${model.score_model."):-1]]
        if not weight_norm:
            sm["use_weight_norm"] = cm["use_weight_norm"] = False
        self.gan = cfg["_target_"].endswith("UniverseGAN")
        self.score_model = ScoreNetwork(**sm)
        self.condition_model = ConditionerNetwork(**cm)
        losses = cfg.get("losses") or {}
        if self.gan and losses.get("use_signal_decoupling"):
            self.signal_decoupling_layer = PReLUConv(sm["n_channels"], 1, 3, padding="same",
                                                     act=losses["signal_decoupling_act"])
        self.edm = cfg.get("edm")
        self.fs = cfg["fs"]
        self.tot_ds = math.prod(sm["rate_factors"])
        self.level_db = cfg["normalization_kwargs"]["level_db"]
        if cfg.get("normalization_norm", 2) != 2 or cfg["normalization_kwargs"].get(
                "zero_mean", True) is not True:
            raise ValueError("the reference normalises by the standard deviation, zero mean")
        self.diffusion = cfg["diffusion"]

    def ema_subs(self):
        """Checkpoint prefixes whose parameters an EMA shadow list covers, in
        its order (``model_parameters()`` of the published module)."""
        subs = ["_edm_model" if self.edm else "score_model", "condition_model"]
        if hasattr(self, "signal_decoupling_layer"):
            subs.append("signal_decoupling_layer")
        return subs

    @torch.no_grad()
    def enhance(self, mix: torch.Tensor, draws, n_steps: int) -> torch.Tensor:
        """mix (B, T) float32 -> the enhanced (B, T); ``draws``: ``n_steps``
        standard normal tensors of the padded batch's shape (B, T_pad, 1), or
        a callable giving the i-th draw."""
        x_len = mix.shape[1]
        mix = mix[:, :, None]
        pad = self.tot_ds - x_len % self.tot_ds
        mix = F.pad(mix, (0, 0, pad // 2, pad - pad // 2))
        mix = mix - torch.mean(mix, dim=(1, 2), keepdim=True)
        std = torch.clamp(torch.std(mix, dim=(1, 2), keepdim=True, correction=1), min=1e-5)
        mix = mix * (10.0 ** (self.level_db / 20.0) / std)
        draw = draws if callable(draws) else (lambda i: draws[i])

        d = self.diffusion
        s_min, s_max, eps = d["sigma_min"], d["sigma_max"], d["epsilon"]
        gamma = (s_max / s_min) ** (-1.0 / (n_steps - 1))
        eta = 1.0 - gamma ** eps
        beta = math.sqrt(1.0 - gamma ** (2.0 * (eps - 1.0)))
        time = torch.linspace(0.0, 1.0, n_steps, device=mix.device).flip(0)
        sigma = s_min * torch.pow(torch.tensor(s_max / s_min, device=mix.device), time)
        bsz = mix.shape[0]
        cond = self.condition_model(mix)
        x = draw(0) * sigma[0]
        if self.edm:
            sd = 10.0 ** (self.edm.get("data_level_db", self.level_db) / 20.0)
            norm = torch.sqrt(sigma ** 2 + sd ** 2)
            skip, w_in, w_out = sd ** 2 / (sigma ** 2 + sd ** 2), 1.0 / norm, sigma * sd / norm
            noise_sig = self.edm["noise"] * sigma
            for i in range(n_steps - 1):
                net = self.score_model(w_in[i] * x, noise_sig[i].expand(bsz), cond)
                x = ((1.0 - eta + eta * skip[i]) * x + eta * w_out[i] * net
                     + (beta * sigma[i + 1]) * draw(i + 1))
            net = self.score_model(w_in[-1] * x, noise_sig[-1].expand(bsz), cond)
            x = skip[-1] * x + w_out[-1] * net
        else:
            for i in range(n_steps - 1):
                score = self.score_model(x, sigma[i].expand(bsz), cond)
                x = x + sigma[i] ** 2 * eta * score + beta * (draw(i + 1) * sigma[i + 1])
            x = x + sigma[-1] ** 2 * self.score_model(x, sigma[-1].expand(bsz), cond)
        x = x[:, pad // 2: x.shape[1] - (pad - pad // 2), 0]
        peak = torch.amax(torch.abs(x), dim=1, keepdim=True)
        return torch.where(peak > 1.0, x / peak, x)
