"""Randomness helpers (JAX package ``utils/random.py``).

Draws are taken from a ``torch.Generator`` as uniform numbers in [0, 1);
the functions here map those draws as the JAX package maps its own, so a
test that feeds JAX's uniform draws gets JAX's values.

``fixed_normal(n)`` is the one draw the JAX package takes from a fixed key,
``jax.random.normal(jax.random.key(0), (n,))`` (the power-iteration start of
its spectral-norm ``Conv2d``): the threefry2x32 counter hash on counters
0..n-1 under key (0, 0), the two output words XORed, turned into a float in
[-1, 1) from the 23 high bits, then into a normal by sqrt(2) erfinv.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011) on uint32 arrays."""
    mask = np.uint64(0xFFFFFFFF)
    ks = [np.uint64(k0), np.uint64(k1), np.uint64(k0 ^ k1 ^ 0x1BD11BDA)]
    x0 = (x0.astype(np.uint64) + ks[0]) & mask
    x1 = (x1.astype(np.uint64) + ks[1]) & mask
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & mask
            x1 = ((x1 << np.uint64(r)) | (x1 >> np.uint64(32 - r))) & mask
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & mask
        x1 = (x1 + ks[(i + 2) % 3] + np.uint64(i + 1)) & mask
    return x0.astype(np.uint32), x1.astype(np.uint32)


# single-precision erfinv (Giles 2010), the polynomial XLA evaluates for
# float32: the port's draws then round where JAX's round
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv of x in (-1, 1)."""
    x = x.float()
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0])
    for c_lt, c_ge in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = torch.where(lt, c_lt, c_ge) + p * w
    return p * x


@lru_cache(maxsize=64)
def _fixed_uniform_np(n: int) -> np.ndarray:
    """JAX's uniform draws in [nextafter(-1, 0), 1) behind
    ``normal(key(0), (n,))``."""
    counters = np.arange(n, dtype=np.uint64)
    b0, b1 = _threefry2x32(0, 0, (counters >> np.uint64(32)).astype(np.uint32),
                           counters.astype(np.uint32))
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.maximum(lo, floats * (np.float32(1.0) - lo) + lo)


def fixed_normal(n: int, device=None) -> torch.Tensor:
    """(n,) float32 standard normals, JAX's ``normal(key(0), (n,))``."""
    u = torch.from_numpy(_fixed_uniform_np(n).copy())
    return (np.float32(math.sqrt(2.0)) * erfinv32(u)).to(device)


def _ndtri(p: float) -> float:
    """The standard normal quantile."""
    return math.sqrt(2.0) * torch.special.erfinv(
        torch.tensor(2.0 * p - 1.0, dtype=torch.float64)).item()


def center_truncated_normal(u: torch.Tensor, area: float = 0.95,
                            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Truncated normal centred at (min + max) / 2 whose untruncated density
    has ``area`` mass inside [min, max], from uniform draws ``u`` in [0, 1)
    (float32): u is stretched over [erf(lower/sqrt2), erf(upper/sqrt2)] and
    inverted, ``jax.random.truncated_normal``'s mapping of the same draws."""
    f32 = torch.float32
    q = _ndtri(area + 0.5 * (1.0 - area))
    mean = 0.5 * (maxval + minval)
    std = torch.tensor(0.5 * (maxval - minval) / q, dtype=f32)
    lower = (torch.tensor(minval - mean, dtype=f32) / std)
    upper = (torch.tensor(maxval - mean, dtype=f32) / std)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=f32)
    a, b = torch.erf(lower / sqrt2), torch.erf(upper / sqrt2)
    x = torch.maximum(a, u.to(f32) * (b - a) + a)
    z = sqrt2 * erfinv32(x)
    z = torch.clamp(z, torch.nextafter(lower, upper).item(),
                    torch.nextafter(upper, lower).item())
    return mean + std * z
