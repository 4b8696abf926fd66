"""UNIVERSE building blocks in (batch, time, channels) layout.

The PReLU -> low-pass -> strided-conv unit, the UNIVERSE ConvBlock (paper
App. D) with FiLM noise conditioning and residual/condition outputs, and the
binomial anti-aliasing filter (JAX package ``nn/blocks.py``).  An eligible
ConvBlock runs its conv chain as one fused kernel
(``ops/kernels/conv_block.py``), and its rate change (PReLU, the strided or
transposed conv, and UNIVERSE++'s low-pass) as another
(``ops/kernels/rate_change.py``).  The port has no lane-packed layout:
the chain always runs on the contiguous (B, T, C) tensor.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv as ops_conv
from ..ops import kernels
from ..ops.kernels import conv_block, rate_change
from ..utils import spans
from .layers import Conv1d, ConvTranspose1d, PReLU
from .lora import LoraLayer
from .snake import AliasFreeSnake

SQRT_HALF = 1.0 / math.sqrt(2.0)


def film(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Feature-wise linear modulation; x: (B, T, C), y: (B, 2C)."""
    c = x.shape[-1]
    if y.shape[-1] != 2 * c:
        raise ValueError("FiLM conditioning must have 2x the feature channels")
    return y[..., None, :c] * x + y[..., None, c:]


@lru_cache(maxsize=32)
def _binomial_filter_np(kernel_size: int) -> np.ndarray:
    """Pascal-row binomial filter normalised to unit RMS (twice, as the
    reference does, blocks.py:62-68)."""
    row = np.array(
        [math.comb(kernel_size - 1, i) for i in range(kernel_size)], np.float64)
    row = row / np.sqrt(np.mean(row**2))
    row = row / np.sqrt(np.mean(row**2))
    return row.astype(np.float32)


def binomial_filter(kernel_size: int, device=None) -> torch.Tensor:
    return torch.tensor(_binomial_filter_np(kernel_size), device=device)


class BinomialAntiAlias(nn.Module):
    """Depthwise 'same' binomial low-pass.  The filter is a non-persistent
    buffer: it is recomputed, never loaded."""

    def __init__(self, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.register_buffer("weights", binomial_filter(kernel_size),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops_conv.depthwise_conv1d_same(x, self.weights)


class LinearProj(nn.Module):
    """1x1-conv projection of the condition added to the input."""

    def __init__(self, in_dim, out_dim=None, weight_norm=False):
        super().__init__()
        out_dim = in_dim if out_dim is None else out_dim
        self.proj = Conv1d(in_dim, out_dim, 1, weight_norm=weight_norm)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        return (self.proj(c) + x) * SQRT_HALF


class PReLUConv(nn.Module):
    """activation -> [binomial low-pass] -> (transposed) conv [+ manual bias].

    With anti-aliasing the conv has no bias and a separate ``bias`` is added
    after the low-pass; the low-pass precedes a downsampling conv and
    follows an upsampling one.
    """

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, use_transpose=False, act_type="prelu",
                 weight_norm=False, antialiasing=False):
        super().__init__()
        self.stride = stride
        self.use_transpose = use_transpose
        self.antialiasing = antialiasing
        self.manual_bias = bias and antialiasing
        self.out_channels = out_channels
        self.act_type = act_type

        conv_bias = bias and not antialiasing
        if use_transpose:
            self.conv = ConvTranspose1d(in_channels, out_channels, kernel_size,
                                        stride=stride, padding=padding,
                                        bias=conv_bias, weight_norm=weight_norm)
        else:
            self.conv = Conv1d(in_channels, out_channels, kernel_size,
                               stride=stride, padding=padding, bias=conv_bias,
                               weight_norm=weight_norm)
        if antialiasing:
            self.low_pass_filter = BinomialAntiAlias(2 * kernel_size + 1)

        if act_type == "prelu":
            self.prelu = PReLU()
        elif act_type == "snake":
            self.prelu = AliasFreeSnake(in_channels, alpha_logscale=True)
        elif act_type == "snakebeta":
            self.prelu = AliasFreeSnake(in_channels, alpha_logscale=True, beta=True)
        elif act_type in ("none", None):
            self.prelu = None
        else:
            raise ValueError("'act_type' should be one of prelu|snake|snakebeta|none")

        if self.manual_bias:
            self.bias = nn.Parameter(torch.zeros(out_channels))

    @torch.no_grad()
    def seed_parameters(self, generator: torch.Generator):
        if self.manual_bias:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.use_transpose and self.stride > 1:
            r = x.shape[1] % self.stride
            if r != 0:
                x = F.pad(x, (0, 0, 0, self.stride - r))
        if self.prelu is not None:
            x = self.prelu(x)
        if self.antialiasing and not self.use_transpose:
            x = self.low_pass_filter(x)
        x = self.conv(x)
        if self.antialiasing and self.use_transpose:
            x = self.low_pass_filter(x)
        if self.manual_bias:
            x = x + self.bias.to(x.dtype)
        return x


class ConvBlock(nn.Module):
    """UNIVERSE ConvBlock: rate-change conv (up/down/none) + three 'same'
    convs (k = 5, 3, 3), FiLM noise conditioning, optional per-stage signal
    conditioning, and residual/condition outputs.  Down blocks return the
    features *before* downsampling as the skip residual."""

    def __init__(self, n_channels, rate_change=None, rate_change_dir="none",
                 act_type="prelu", antialiasing=False, weight_norm=False,
                 signal_cond_type=None):
        super().__init__()
        if rate_change_dir not in ("up", "down", "none"):
            raise ValueError("rate_change_dir must be up|down|none")
        if rate_change_dir in ("up", "down") and rate_change is None:
            raise ValueError("rate_change required for up/down blocks")
        self.rate = rate_change
        self.rate_change_dir = rate_change_dir

        if rate_change_dir == "down":
            self.in_channels, self.out_channels = n_channels, 2 * n_channels
            self.rate_change_conv = PReLUConv(
                n_channels, 2 * n_channels, rate_change, stride=rate_change,
                weight_norm=weight_norm, antialiasing=antialiasing)
        elif rate_change_dir == "up":
            self.in_channels, self.out_channels = 2 * n_channels, n_channels
            self.rate_change_conv = PReLUConv(
                2 * n_channels, n_channels, rate_change, stride=rate_change,
                use_transpose=True, weight_norm=weight_norm,
                antialiasing=antialiasing)
        else:
            self.in_channels = self.out_channels = n_channels
            self.rate_change_conv = None

        self.conv1 = PReLUConv(n_channels, n_channels, 5, padding="same",
                               act_type=act_type, weight_norm=weight_norm)
        self.conv2 = PReLUConv(n_channels, n_channels, 3, padding="same",
                               act_type=act_type, weight_norm=weight_norm)
        self.conv3 = PReLUConv(n_channels, n_channels, 3, padding="same",
                               act_type=act_type, weight_norm=weight_norm)

        if signal_cond_type == "linear":
            self.signal_cond_proj = LinearProj(n_channels, weight_norm=weight_norm)
        elif signal_cond_type in ("none", None):
            self.signal_cond_proj = None
        else:
            raise ValueError("signal_cond_type must be linear|none")
        # kernel-layout weights by dtype, with the parameters they came from
        self._chain_cache = {}

    def _chain_params(self):
        return [p for c in (self.conv1, self.conv2, self.conv3)
                for p in (c.conv.weight, c.conv.bias, c.prelu.weight)]

    @staticmethod
    def _kernel_ready(convs, h: Optional[torch.Tensor]) -> bool:
        """The kernels take the plain-PReLU inference configuration of the
        PReLUConvs ``convs``: kernels enabled, inference (``inference_scope``
        or no autograd), folded weights without LoRA adapters or
        tensor-parallel shards, one PReLU slope per conv.  They have no
        backward, so with autograd on nothing that needs a gradient (``h`` or
        a parameter of ``convs``) may reach them."""
        if not kernels.enabled() or not kernels.in_inference():
            return False
        for conv in convs:
            # a LoRA adapter, in any autograd state (JAX nn/blocks.py:222-224):
            # the kernel would read the base weight without the update
            if isinstance(conv.conv, LoraLayer):
                return False
            if conv.act_type != "prelu" or not conv.conv.folded:
                return False
            # a tensor-parallel shard: the kernel reads whole weights
            if getattr(conv.conv, "tp_dims", None):
                return False
            if conv.prelu.num_parameters != 1:
                return False
        return not (torch.is_grad_enabled() and (
            (h is not None and h.requires_grad)
            or any(p.requires_grad for c in convs for p in c.parameters())))

    def _fused_eligible(self, h: Optional[torch.Tensor] = None) -> bool:
        """The fused chain kernel takes what ``_kernel_ready`` takes, without
        a LinearProj.  Given ``h`` on the card, its dtype, width and batch
        must be ones the kernel takes (the JAX package's ``fused_conv_chain``
        returns None for the rest); the plain version a CPU tensor runs
        takes any."""
        if self.signal_cond_proj is not None:
            return False
        if not self._kernel_ready((self.conv1, self.conv2, self.conv3), h):
            return False
        if h is not None and h.device.type == "cuda":
            b, t, c = h.shape
            return (h.dtype in conv_block.ROUTES and c in conv_block.WIDTHS
                    and 1 <= b <= 65535 and t >= 1)
        return True

    def _rate_kernel_eligible(self, h: torch.Tensor) -> bool:
        """The rate-change kernel takes what ``_kernel_ready`` takes, on a
        float32 CUDA tensor of a shape ``rate_change.takes``; everything else
        (training, bf16, the CPU, LoRA) runs the module."""
        conv = self.rate_change_conv
        return (self._kernel_ready((conv,), h)
                and rate_change.takes(self.rate_change_dir, h, conv.conv.weight, self.rate))

    def _rate_span(self, h: torch.Tensor, kernel: bool, t: int):
        """The ``conv_block.rate_change`` span of the rate change of h's rows
        that hands the kernel or the module ``t`` samples a row: the block's
        width C, its rate r, the conv's Cin and Cout, and whether it
        low-passes, so that a reader can work out the launch's bound."""
        return spans.span("conv_block.rate_change", C=min(self.in_channels, self.out_channels),
                          direction=self.rate_change_dir, entry="kernel" if kernel else "plain",
                          r=self.rate, Cin=self.in_channels, Cout=self.out_channels,
                          rows=h.shape[0], T=t, antialiased=self.rate_change_conv.antialiasing)

    def _rate_change(self, h: torch.Tensor, kernel: bool) -> torch.Tensor:
        """The rate change of h: one kernel launch, or the module."""
        conv = self.rate_change_conv
        if not kernel:
            return conv(h)
        return rate_change.rate_change(
            h.contiguous(), conv.conv.weight, conv.bias if conv.manual_bias else conv.conv.bias,
            conv.prelu.weight, self.rate, self.rate_change_dir,
            conv.low_pass_filter.weights if conv.antialiasing else None)

    def _chain_args(self, dtype) -> Tuple[torch.Tensor, ...]:
        """The kernel's weight arguments: (K, Cin, Cout) weights and biases of
        the three convs in ``dtype``, and their PReLU slopes in float32,
        rounded through ``dtype`` as the networks' parameters are.  Made once
        per dtype, and again only when a parameter is replaced or written."""
        params = self._chain_params()
        key = tuple((p.data_ptr(), p._version) for p in params)
        cached = self._chain_cache.get(dtype)
        if cached is None or cached[0] != key:
            args = []
            for w, b, a in zip(params[0::3], params[1::3], params[2::3]):
                args += [w.detach().to(dtype).permute(2, 1, 0).contiguous(),
                         b.detach().to(dtype).contiguous(),
                         a.detach().to(dtype).float().contiguous()]
            cached = self._chain_cache[dtype] = (key, tuple(args))
        return cached[1]

    def forward(self, h: torch.Tensor, noise_cond: Optional[torch.Tensor] = None,
                input_cond: Optional[torch.Tensor] = None,
                res: Optional[torch.Tensor] = None,
                length: Optional[int] = None):
        """Returns (next-stage h, skip residual, condition output).  While a
        profiler records, the rate change is the span
        ``conv_block.rate_change`` (its kernel's launch, or the module) and
        the chain ``conv_block.chain``: the kernel's launch with the copies
        in front of it, or the plain convs (``utils/spans.py``)."""
        if self.rate_change_dir == "up":
            kernel = self._rate_kernel_eligible(h)
            pad = length is not None and self.rate * h.shape[1] < length
            with self._rate_span(h, kernel, h.shape[1] + int(pad)):
                if pad:
                    h = F.pad(h, (0, 0, 0, 1))
                h = self._rate_change(h, kernel)
                if length is not None:
                    if h.shape[1] > length:
                        h = h[:, :length]
                    elif h.shape[1] < length:
                        h = F.pad(h, (0, 0, 0, length - h.shape[1]))

        if res is not None:
            if self.rate_change_dir == "down":
                raise ValueError("residual input not allowed for down blocks")
            h = (h + res) * SQRT_HALF

        fused = self._fused_eligible(h)
        t, c = h.shape[-2:]
        with spans.span("conv_block.chain", C=c, T=t, entry="main" if fused else "plain"):
            if fused:
                h = h.contiguous()
                nc = None if noise_cond is None else noise_cond.contiguous()
                ic = None if input_cond is None else input_cond.contiguous()
                v_out, cond_out = conv_block.fused_conv_chain(
                    h, *self._chain_args(h.dtype), noise_cond=nc, input_cond=ic)
            else:
                cond_out = self.conv1(h)
                if input_cond is not None:
                    if self.signal_cond_proj is None:
                        c = (cond_out + input_cond) * SQRT_HALF
                    else:
                        c = self.signal_cond_proj(cond_out, input_cond)
                else:
                    c = cond_out
                if noise_cond is not None:
                    c = film(c, noise_cond)
                c = self.conv2(c)
                c = self.conv3(c)
                v_out = (h + c) * SQRT_HALF

        if self.rate_change_dir == "down":
            kernel = self._rate_kernel_eligible(v_out)
            r = h.shape[1] % self.rate
            pad = self.rate - r if r != 0 and not kernel else 0
            with self._rate_span(v_out, kernel, h.shape[1] + pad):
                v_pad = F.pad(v_out, (0, 0, 0, pad)) if pad else v_out
                return self._rate_change(v_pad, kernel), v_out, cond_out
        return v_out, v_out, cond_out
