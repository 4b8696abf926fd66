"""Chunked (overlap-add) enhancement of arbitrarily long audio (JAX package
``inference/chunked.py``).

The waveform is split into fixed-length chunks with 25 % overlap by
default; the chunks of all rows are enhanced in blocks of ``max_batch``
rows, one ``model.enhance`` call per block, and blended by overlap-add with
raised-cosine crossfades and a weight normalisation, so each chunk sees
``overlap``/2 of context on either side and the seams do not show.

The conditioner's context and the loudness normalisation are per chunk, so
``keep_rms`` defaults to True: every chunk is rescaled to its input RMS and
the output follows the recording's level contour (without it a quiet
chunk's noise floor would be raised to the normalised level).  The sampler
noise comes from the caller's ``torch.Generator``, drawn block by block in
order.  The last block is not padded to ``max_batch`` rows: no row's output
depends on the rows beside it.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch


def _crossfade_window(chunk: int, ov: int) -> np.ndarray:
    """Raised-cosine ramps of length ``ov`` at both ends, flat middle.

    The product of an up-ramp and a down-ramp, so the window stays smooth
    when ov > chunk/2 (the ramps then overlap); for ov <= chunk/2 it is the
    ramp/flat/ramp window.  The blender's weight normalisation handles
    overlap sums that are not one."""
    w = np.ones(chunk, np.float32)
    if ov > 0:
        ramp = (0.5 - 0.5 * np.cos(np.pi * (np.arange(ov) + 0.5) / ov)
                ).astype(np.float32)
        head = np.ones(chunk, np.float32)
        head[:ov] = ramp
        tail = np.ones(chunk, np.float32)
        tail[-ov:] = ramp[::-1]
        w = head * tail
    return w


def make_chunked_enhancer(model, chunk_seconds: float = 10.0,
                          overlap: float = 0.25, max_batch: int = 8,
                          **enhance_kwargs) -> Callable:
    """Build ``fn(mix, generator=None) -> enhanced`` for long-form audio.

    mix: (T,) or (B, T) array at ``model.fs``; the result is a float32 numpy
    array of the same shape.
    """
    if not 0.0 <= overlap < 1.0:
        # a negative overlap makes hop > chunk and leaves gaps no chunk covers
        raise ValueError(f"overlap must be in [0, 1), got {overlap}")
    chunk = int(round(chunk_seconds * model.fs))
    ov = int(round(chunk * overlap))
    hop = chunk - ov
    if hop < 1:
        raise ValueError(
            f"chunk_seconds={chunk_seconds} with overlap={overlap} leaves a "
            f"hop of {hop} samples; increase the chunk or lower the overlap")
    enhance_kwargs = dict(enhance_kwargs)
    enhance_kwargs.setdefault("keep_rms", True)
    window = _crossfade_window(chunk, ov)

    def enhance_chunked(mix, generator: Optional[torch.Generator] = None):
        x = np.asarray(mix, np.float32)
        single = x.ndim == 1
        if single:
            x = x[None]
        b, t = x.shape

        # the overlap-add path also covers t <= chunk (one chunk, and
        # out * w / w == out)
        n_chunks = max(1, math.ceil(max(t - ov, 1) / hop))
        t_pad = (n_chunks - 1) * hop + chunk
        xp = np.pad(x, ((0, 0), (0, t_pad - t)))
        starts = np.arange(n_chunks) * hop
        frames = np.stack([xp[:, s: s + chunk] for s in starts], axis=1)
        flat = frames.reshape(b * n_chunks, chunk)

        outs = np.empty_like(flat)
        for i in range(0, flat.shape[0], max_batch):
            out = model.enhance(torch.from_numpy(flat[i: i + max_batch]),
                                generator=generator, **enhance_kwargs)
            outs[i: i + max_batch] = out.float().cpu().numpy()

        outs = outs.reshape(b, n_chunks, chunk)
        acc = np.zeros((b, t_pad), np.float32)
        wacc = np.zeros(t_pad, np.float32)
        for j, s in enumerate(starts):
            acc[:, s: s + chunk] += outs[:, j] * window
            wacc[s: s + chunk] += window
        acc /= np.maximum(wacc, 1e-8)[None, :]
        acc = acc[:, :t]
        return acc[0] if single else acc

    return enhance_chunked


def enhance_chunked(model, mix, generator: Optional[torch.Generator] = None,
                    chunk_seconds: float = 10.0, overlap: float = 0.25,
                    max_batch: int = 8, **enhance_kwargs):
    """One call of :func:`make_chunked_enhancer`'s enhancer."""
    fn = make_chunked_enhancer(model, chunk_seconds=chunk_seconds,
                               overlap=overlap, max_batch=max_batch,
                               **enhance_kwargs)
    return fn(mix, generator=generator)
