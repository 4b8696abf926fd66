"""Plain PyTorch layers of the UNIVERSE networks, in (batch, time, channels)
layout, under the published ``state_dict`` names (line/open-universe).

This is the benchmark's own frozen copy: it imports nothing of the program
under test.  Every layer is float32 arithmetic on ``torch.nn.functional``; the
bidirectional GRU is written as matrix products, step by step, so that a FLOP
counter sees its work.  Built with ``weight_norm=True`` a layer holds
``weight_g``/``weight_v`` (the checkpoint's layout, ``fold.py`` folds them);
the forward always reads a plain ``weight``.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SQRT_HALF = 1.0 / math.sqrt(2.0)


class Weighted(nn.Module):
    """A weight (or weight-norm pair) and an optional bias; ``fan_in`` is the
    bound's denominator of the published initialisation."""

    def _params(self, shape, n_bias, bias, weight_norm, fan_in):
        self.fan_in = fan_in
        if weight_norm:
            self.weight_g = nn.Parameter(torch.empty((shape[0],) + (1,) * (len(shape) - 1)))
            self.weight_v = nn.Parameter(torch.empty(shape))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(n_bias)) if bias else None


class Conv1d(Weighted):
    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1, bias=True,
                 weight_norm=False):
        super().__init__()
        self.stride, self.padding, self.groups, self.k = stride, padding, groups, k
        self._params((cout, cin // groups, k), cout, bias, weight_norm, (cin // groups) * k)

    def forward(self, x):
        if self.padding == "same":
            lo = (self.k - 1) // 2
            pads = (lo, self.k - 1 - lo)
        else:
            pads = (self.padding, self.padding)
        xt = F.pad(x.transpose(1, 2), pads)
        y = F.conv1d(xt, self.weight, self.bias, self.stride, 0, 1, self.groups)
        return y.transpose(1, 2)


class ConvTranspose1d(Weighted):
    """weight (Cin, Cout, K): torch normalises a transposed conv per input
    channel, and its published fan-in is Cout * K."""

    def __init__(self, cin, cout, k, stride=1, bias=True, weight_norm=False):
        super().__init__()
        self.stride = stride
        self._params((cin, cout, k), cout, bias, weight_norm, cout * k)

    def forward(self, x):
        return F.conv_transpose1d(x.transpose(1, 2), self.weight, self.bias,
                                  self.stride).transpose(1, 2)


class Linear(Weighted):
    def __init__(self, cin, cout, bias=True, weight_norm=False):
        super().__init__()
        self._params((cout, cin), cout, bias, weight_norm, cin)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class PReLU(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.reshape(()) * x)


class GRU(nn.Module):
    """Bidirectional GRU, batch first, torch's gate order (r, z, n) with the
    n gate's hidden bias inside the reset product.  Both directions advance
    together: one batched product of the hidden states per time step."""

    def __init__(self, n_in, hidden, num_layers):
        super().__init__()
        self.hidden, self.num_layers = hidden, num_layers
        for layer in range(num_layers):
            width = n_in if layer == 0 else 2 * hidden
            for sfx in ("", "_reverse"):
                s = f"_l{layer}{sfx}"
                setattr(self, "weight_ih" + s, nn.Parameter(torch.empty(3 * hidden, width)))
                setattr(self, "weight_hh" + s, nn.Parameter(torch.empty(3 * hidden, hidden)))
                setattr(self, "bias_ih" + s, nn.Parameter(torch.empty(3 * hidden)))
                setattr(self, "bias_hh" + s, nn.Parameter(torch.empty(3 * hidden)))

    def forward(self, x):
        h_n = self.hidden
        for layer in range(self.num_layers):
            p = [(getattr(self, f"weight_ih_l{layer}{s}"), getattr(self, f"weight_hh_l{layer}{s}"),
                  getattr(self, f"bias_ih_l{layer}{s}"), getattr(self, f"bias_hh_l{layer}{s}"))
                 for s in ("", "_reverse")]
            # input products of every step at once; the reverse direction
            # reads time backwards
            gi = torch.stack([F.linear(x, p[0][0], p[0][2]),
                              F.linear(x.flip(1), p[1][0], p[1][2])])   # (2, B, T, 3H)
            w_hh = torch.stack([p[0][1], p[1][1]]).transpose(1, 2)      # (2, H, 3H)
            b_hh = torch.stack([p[0][3], p[1][3]])[:, None, :]          # (2, 1, 3H)
            h = x.new_zeros(2, x.shape[0], h_n)
            outs = []
            for t in range(x.shape[1]):
                gh = torch.baddbmm(b_hh, h, w_hh)
                g = gi[:, :, t]
                rz = torch.sigmoid(g[..., :2 * h_n] + gh[..., :2 * h_n])
                r, z = rz[..., :h_n], rz[..., h_n:]
                n = torch.tanh(g[..., 2 * h_n:] + r * gh[..., 2 * h_n:])
                h = n + z * (h - n)
                outs.append(h)
            out = torch.stack(outs, dim=2)                              # (2, B, T, H)
            x = torch.cat([out[0], out[1].flip(1)], dim=-1)
        return x


@lru_cache(maxsize=16)
def binomial_np(k: int) -> np.ndarray:
    """Pascal row normalised to unit RMS (twice, as published)."""
    row = np.array([math.comb(k - 1, i) for i in range(k)], np.float64)
    row = row / np.sqrt(np.mean(row ** 2))
    row = row / np.sqrt(np.mean(row ** 2))
    return row.astype(np.float32)


class LowPass(nn.Module):
    """Depthwise 'same' binomial filter; the taps are recomputed, never
    loaded."""

    def __init__(self, k):
        super().__init__()
        self.k = k
        self.register_buffer("weights", torch.from_numpy(binomial_np(k)), persistent=False)

    def forward(self, x):
        c, k = x.shape[-1], self.k
        w = self.weights.reshape(1, 1, k).expand(c, 1, k)
        xt = F.pad(x.transpose(1, 2), ((k - 1) // 2, k - 1 - (k - 1) // 2))
        return F.conv1d(xt, w, groups=c).transpose(1, 2)


class Snake(nn.Module):
    """The signal-decoupling layer's activation (log-scale alpha).  Only its
    parameter is needed here: ``enhance`` without ``warm_start`` or
    ``use_aux_signal`` never runs the layer."""

    def __init__(self, c):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(c))


class _Nest(nn.Module):
    def __init__(self, **mods):
        super().__init__()
        for k, v in mods.items():
            setattr(self, k, v)


class PReLUConv(nn.Module):
    """activation -> [low-pass] -> (transposed) conv [+ bias after the
    low-pass].  The low-pass precedes a downsampling conv and follows an
    upsampling one."""

    def __init__(self, cin, cout, k, stride=1, padding=0, transpose=False, act="prelu",
                 weight_norm=False, antialiasing=False):
        super().__init__()
        self.stride, self.transpose, self.antialiasing = stride, transpose, antialiasing
        conv_bias = not antialiasing
        if transpose:
            self.conv = ConvTranspose1d(cin, cout, k, stride, conv_bias, weight_norm)
        else:
            self.conv = Conv1d(cin, cout, k, stride, padding, bias=conv_bias,
                               weight_norm=weight_norm)
        if antialiasing:
            self.low_pass_filter = LowPass(2 * k + 1)
        if act == "prelu":
            self.prelu = PReLU()
        elif act == "snake":
            self.prelu = _Nest(act=_Nest(act=Snake(cin)))
        else:
            raise ValueError(act)
        if antialiasing:
            self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        if not self.transpose and self.stride > 1 and x.shape[1] % self.stride:
            x = F.pad(x, (0, 0, 0, self.stride - x.shape[1] % self.stride))
        x = self.prelu(x)
        if self.antialiasing and not self.transpose:
            x = self.low_pass_filter(x)
        x = self.conv(x)
        if self.antialiasing:
            if self.transpose:
                x = self.low_pass_filter(x)
            x = x + self.bias
        return x


def film(x, y):
    c = x.shape[-1]
    return y[:, None, :c] * x + y[:, None, c:]


class ConvBlock(nn.Module):
    """rate change (up/down/none) + conv5, conv3, conv3 with FiLM and signal
    conditioning; returns (next h, skip residual, condition output)."""

    def __init__(self, c, rate=None, direction="none", weight_norm=False, antialiasing=False):
        super().__init__()
        self.rate, self.direction = rate, direction
        if direction == "down":
            self.rate_change_conv = PReLUConv(c, 2 * c, rate, stride=rate, weight_norm=weight_norm,
                                              antialiasing=antialiasing)
        elif direction == "up":
            self.rate_change_conv = PReLUConv(2 * c, c, rate, stride=rate, transpose=True,
                                              weight_norm=weight_norm, antialiasing=antialiasing)
        for name, k in (("conv1", 5), ("conv2", 3), ("conv3", 3)):
            setattr(self, name, PReLUConv(c, c, k, padding="same", weight_norm=weight_norm))

    def forward(self, h, noise_cond=None, input_cond=None, res=None, length=None):
        if self.direction == "up":
            if length is not None and self.rate * h.shape[1] < length:
                h = F.pad(h, (0, 0, 0, 1))
            h = self.rate_change_conv(h)
            if length is not None:
                h = h[:, :length] if h.shape[1] > length else \
                    F.pad(h, (0, 0, 0, length - h.shape[1]))
        if res is not None:
            h = (h + res) * SQRT_HALF
        cond_out = self.conv1(h)
        c = cond_out if input_cond is None else (cond_out + input_cond) * SQRT_HALF
        if noise_cond is not None:
            c = film(c, noise_cond)
        v = (h + self.conv3(self.conv2(c))) * SQRT_HALF
        if self.direction == "down":
            r = h.shape[1] % self.rate
            v_pad = F.pad(v, (0, 0, 0, self.rate - r)) if r else v
            return self.rate_change_conv(v_pad), v, cond_out
        return v, v, cond_out
