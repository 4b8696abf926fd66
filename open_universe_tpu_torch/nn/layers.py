"""Leaf layers: Conv1d, ConvTranspose1d, Linear, Conv2d, PReLU, GRU,
LayerNorm.

Data is (batch, time, channels) as in the JAX package (``Conv2d``, the
discriminators' layer, takes NCHW where JAX takes NHWC); parameters are in
PyTorch's layout under the reference ``state_dict`` names, so
``utils/convert.py`` maps a JAX param tree onto them leaf by leaf.  With
``weight_norm`` a layer holds ``weight_g``/``weight_v`` (torch
``weight_norm(dim=0)``: the norm runs over every axis but the first, which is
the output channel of a conv or linear and the INPUT channel of a transposed
conv) until ``fold_weight_norm`` replaces them with ``weight``.  Weights are
cast to the input's dtype at use, so a bf16 input runs the layer in bf16.

A tensor-parallel run (``parallel/tp.py``) stores some weights as shards;
``effective_weight`` and ``GRU.forward`` gather them whole where they are
used.

``seed_parameters(generator)`` draws the JAX package's initialisation
(uniform in +-1/sqrt(fan_in)); ``init_weights`` applies it to a whole model.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv as ops_conv
from ..parallel import tp
from ..utils.random import fixed_normal


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """g * v / ||v||, the norm over every axis but the first."""
    dims = tuple(range(1, v.dim()))
    norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))
    return g * v / torch.clamp(norm, min=1e-12)


class _Weighted(nn.Module):
    """A weight, optionally weight-normed, plus an optional bias."""

    def _make_params(self, shape: Sequence[int], n_bias: int, bias: bool,
                     weight_norm: bool):
        self.weight_norm = weight_norm
        if weight_norm:
            self.weight_g = nn.Parameter(
                torch.empty((shape[0],) + (1,) * (len(shape) - 1)))
            self.weight_v = nn.Parameter(torch.empty(shape))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        if bias:
            self.bias = nn.Parameter(torch.empty(n_bias))
        else:
            self.register_parameter("bias", None)

    @property
    def folded(self) -> bool:
        return "weight" in self._parameters

    def effective_weight(self) -> torch.Tensor:
        if self.folded:
            return tp.weight(self, "weight")
        return weight_norm(self.weight_g, tp.weight(self, "weight_v"))

    @torch.no_grad()
    def fold_weight_norm(self) -> None:
        """Replace (weight_g, weight_v) by the weight they define."""
        if self.folded:
            return
        w = self.effective_weight().detach().clone()
        del self.weight_g, self.weight_v
        self.weight = nn.Parameter(w)

    @torch.no_grad()
    def _seed(self, generator: torch.Generator, fan_in: int):
        bound = 1.0 / math.sqrt(fan_in)
        p = self.weight if self.folded else self.weight_v
        w = _uniform(p.shape, bound, generator)
        p.copy_(w)
        if not self.folded:
            dims = tuple(range(1, w.dim()))
            self.weight_g.copy_(torch.sqrt(torch.sum(w * w, dim=dims,
                                                     keepdim=True)))
        if self.bias is not None:
            self.bias.copy_(_uniform(self.bias.shape, bound, generator))


class Conv1d(_Weighted):
    """weight (Cout, Cin // groups, K); weight_g (Cout, 1, 1)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias=True, weight_norm=False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self._make_params((out_channels, in_channels // groups, kernel_size),
                          out_channels, bias, weight_norm)

    def seed_parameters(self, generator: torch.Generator):
        self._seed(generator, (self.in_channels // self.groups) * self.kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops_conv.conv1d(x, self.effective_weight(), self.bias,
                               stride=self.stride, padding=self.padding,
                               dilation=self.dilation, groups=self.groups)


class ConvTranspose1d(_Weighted):
    """weight (Cin, Cout, K); weight_g (Cin, 1, 1): torch normalises a
    transposed conv per input channel."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, weight_norm=False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self._make_params((in_channels, out_channels, kernel_size),
                          out_channels, bias, weight_norm)

    def seed_parameters(self, generator: torch.Generator):
        # torch quirk: a transposed conv's fan_in is Cout * K
        self._seed(generator, self.out_channels * self.kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops_conv.conv_transpose1d(x, self.effective_weight(), self.bias,
                                         stride=self.stride, padding=self.padding)


class Linear(_Weighted):
    """weight (Out, In); weight_g (Out, 1)."""

    def __init__(self, in_features, out_features, bias=True, weight_norm=False):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self._make_params((out_features, in_features), out_features, bias,
                          weight_norm)

    def seed_parameters(self, generator: torch.Generator):
        self._seed(generator, self.in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops_conv.linear(x, self.effective_weight(), self.bias)


class Conv2d(_Weighted):
    """2-D conv on NCHW; weight (Cout, Cin, KH, KW), weight_g (Cout, 1, 1, 1).

    ``spectral_norm`` divides the weight by its largest singular value,
    estimated as the JAX package does on every call: ``sn_power_iters``
    power iterations on the (Cout, Cin*KH*KW) matrix from JAX's fixed start
    vector (``utils/random.py::fixed_normal``), the vectors detached, so the
    gradient flows through sigma's dependence on the weight only.
    """

    def __init__(self, in_channels, out_channels, kernel_size, stride=(1, 1),
                 padding=(0, 0), bias=True, weight_norm=False,
                 spectral_norm=False, sn_power_iters=8):
        super().__init__()
        pair = (lambda v: (v, v) if isinstance(v, int) else tuple(v))
        if weight_norm and spectral_norm:
            raise ValueError("weight_norm and spectral_norm are exclusive")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = pair(kernel_size)
        self.stride = pair(stride)
        self.padding = pair(padding)
        self.spectral_norm = spectral_norm
        self.sn_power_iters = sn_power_iters
        self._make_params((out_channels, in_channels) + self.kernel_size,
                          out_channels, bias, weight_norm)

    def seed_parameters(self, generator: torch.Generator):
        kh, kw = self.kernel_size
        self._seed(generator, self.in_channels * kh * kw)

    def effective_weight(self) -> torch.Tensor:
        w = super().effective_weight()
        if not self.spectral_norm:
            return w
        mat = w.reshape(w.shape[0], -1).float()
        with torch.no_grad():
            u = fixed_normal(mat.shape[0], device=w.device)
            for _ in range(self.sn_power_iters):
                v = mat.T @ u
                v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)
                u = mat @ v
                u = u / torch.clamp(torch.linalg.vector_norm(u), min=1e-12)
        sigma = u @ (mat @ v)
        return w / torch.clamp(sigma, min=1e-12).to(w.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.effective_weight().to(x.dtype), b,
                        stride=self.stride, padding=self.padding)


class PReLU(nn.Module):
    """torch.nn.PReLU: one shared slope by default, init 0.25; slopes run
    along the last (channel) axis."""

    def __init__(self, num_parameters: int = 1, init: float = 0.25):
        super().__init__()
        self.num_parameters = num_parameters
        self.init_val = init
        self.weight = nn.Parameter(torch.full((num_parameters,), init))

    @torch.no_grad()
    def seed_parameters(self, generator: torch.Generator):
        self.weight.fill_(self.init_val)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight.to(x.dtype)
        if self.num_parameters == 1:
            a = a.reshape(())
        return torch.where(x >= 0, x, a * x)


class GRU(nn.GRU):
    """Bidirectional multi-layer GRU, batch first, gate order (r, z, n) with
    the n-gate hidden bias inside the reset product (torch.nn.GRU).  The
    weights are torch's; the JAX package stores their transposes."""

    def __init__(self, input_size, hidden_size, num_layers=1, bidirectional=True):
        super().__init__(input_size, hidden_size, num_layers=num_layers,
                         batch_first=True, bidirectional=bidirectional)

    @torch.no_grad()
    def seed_parameters(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.hidden_size)
        for name in self._flat_weights_names:
            p = getattr(self, name)
            p.copy_(_uniform(p.shape, bound, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, In) -> (B, T, H * n_dir).  cuDNN's backward needs the
        forward in training mode, which is taken only where a backward can
        follow."""
        n_dir = 2 if self.bidirectional else 1
        weights = [tp.weight(self, n).to(x.dtype) for n in self._flat_weights_names]
        h0 = x.new_zeros(self.num_layers * n_dir, x.shape[0], self.hidden_size)
        train = self.training and torch.is_grad_enabled()
        out, _ = torch.gru(x, h0, weights, True, self.num_layers, 0.0, train,
                           self.bidirectional, True)
        return out


class LayerNorm(nn.Module):
    """torch.nn.LayerNorm over the trailing ``shape`` dims, affine
    elementwise (weight 1, bias 0 at init), eps 1e-5."""

    def __init__(self, shape, eps: float = 1e-5):
        super().__init__()
        self.shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(self.shape))
        self.bias = nn.Parameter(torch.zeros(self.shape))

    @torch.no_grad()
    def seed_parameters(self, generator: torch.Generator):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


def init_weights(module: nn.Module, seed: int = 0) -> nn.Module:
    """Draw every parameter of ``module`` from one seeded CPU generator, in
    module order."""
    generator = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "seed_parameters"):
            m.seed_parameters(generator)
    return module

