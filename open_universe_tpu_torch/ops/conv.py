"""1-D convolution primitives in the JAX package's (batch, time, channels)
layout, on ``torch.nn.functional``.

Weights are in PyTorch's layout, as the port's modules hold them:
    conv1d:            (Cout, Cin // groups, K)
    conv_transpose1d:  (Cin, Cout, K)
    linear:            (Out, In)
(the JAX package keeps (K, Cin, Cout), with the transposed conv's taps
flipped; ``utils/convert.py`` maps one to the other).  Weights and biases are
cast to the input's dtype, as the JAX ops do.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[str, int, Tuple[int, int]]


def _norm_padding(padding: Padding, kernel_size: int, dilation: int = 1):
    if isinstance(padding, str):
        if padding == "same":
            eff = dilation * (kernel_size - 1)
            return (eff // 2, eff - eff // 2)
        if padding == "valid":
            return (0, 0)
        raise ValueError(f"unknown padding {padding!r}")
    if isinstance(padding, int):
        return (padding, padding)
    return tuple(padding)


def _cast(b: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if b is None else b.to(dtype)


def conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding: Padding = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """torch.nn.Conv1d on x: (B, T, Cin) -> (B, T', Cout); 'same' puts the odd
    sample of an even total pad on the right."""
    lo, hi = _norm_padding(padding, w.shape[-1], dilation)
    xt = x.transpose(1, 2)
    if lo != hi:
        xt = F.pad(xt, (lo, hi))
        lo = 0
    y = F.conv1d(xt, w.to(x.dtype), _cast(b, x.dtype), stride, lo, dilation,
                 groups)
    return y.transpose(1, 2)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, stride: int = 1,
                     padding: int = 0, output_padding: int = 0) -> torch.Tensor:
    """torch.nn.ConvTranspose1d on x: (B, T, Cin); output length
    (T - 1) * stride - 2 * padding + K + output_padding."""
    y = F.conv_transpose1d(x.transpose(1, 2), w.to(x.dtype), _cast(b, x.dtype),
                           stride, padding, output_padding)
    return y.transpose(1, 2)


def depthwise_conv1d_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The same 1-D FIR filter on every channel, 'same' padding.
    x: (B, T, C); kernel: (K,)."""
    c = x.shape[-1]
    k = kernel.shape[0]
    w = kernel.to(x.dtype).reshape(1, 1, k).expand(c, 1, k)
    xt = F.pad(x.transpose(1, 2), ((k - 1) // 2, k - 1 - (k - 1) // 2))
    return F.conv1d(xt, w, groups=c).transpose(1, 2)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense layer; w: (Out, In)."""
    return F.linear(x, w.to(x.dtype), _cast(b, x.dtype))
