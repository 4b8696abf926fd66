"""Ensemble signal median (JAX package ``utils/stats.py``; reference
utils/stats.py).

For each sample position, find the ensemble member that holds the median
rank; the member that wins the most positions is returned whole.
"""
from __future__ import annotations

import torch


def signal_median(signal: torch.Tensor) -> torch.Tensor:
    """signal: (ensemble, batch, ...) -> (batch, ...).

    The algorithm the reference documents (its stats.py docstring), as the
    JAX package computes it, not the reference's code, which tracks the rank
    of the fixed member n // 2.  The sort is stable and a tie in the count
    goes to the lowest member, as in JAX.
    """
    shape = signal.shape
    n = shape[0]
    flat = signal.reshape(n, shape[1], -1)  # (E, B, S)
    sorted_idx = torch.argsort(flat, dim=0, stable=True)
    member = sorted_idx[n // 2]  # (B, S): the median member per sample
    counts = torch.zeros(shape[1], n, dtype=torch.int64, device=signal.device)
    counts.scatter_add_(1, member, torch.ones_like(member))
    # the first of the largest counts: argmax on an integer tie key
    # (count * n - index) cannot pick a later member
    idx = torch.arange(n, device=signal.device)
    select = torch.argmax(counts * n - idx, dim=1)  # (B,)
    med = torch.gather(flat, 0, select[None, :, None].expand(1, *flat.shape[1:]))[0]
    return med.reshape(shape[1:])
