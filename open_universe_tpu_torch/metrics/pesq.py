"""Batched PESQ wrapper (reference metrics/pesq.py:26-80; the port's copy of
the JAX package's ``metrics/pesq.py``).

Uses the conformant external ``pesq`` package when installed, otherwise the
in-house P.862 implementation (metrics/p862.py)."""
from __future__ import annotations

import numpy as np

from ..data.audio import resample_audio
from .p862 import resolve_pesq


class PESQ:
    def __init__(self, mode: str = "wb", audio_fs: int = 16000,
                 pesq_fs: int = 16000):
        self._pesq, self.conformant = resolve_pesq()
        self.mode = mode
        self.pesq_fs = pesq_fs
        self.audio_fs = audio_fs

    def __call__(self, est, ref) -> float:
        est = np.asarray(est)
        ref = np.asarray(ref)
        if self.pesq_fs != self.audio_fs:
            est = resample_audio(est, self.audio_fs, self.pesq_fs)
            ref = resample_audio(ref, self.audio_fs, self.pesq_fs)
        vals = []
        for ii in range(est.shape[0]):
            try:
                vals.append(self._pesq(self.pesq_fs, ref[ii, 0], est[ii, 0],
                                       self.mode))
            except Exception:
                continue
        return float(np.mean(vals)) if vals else float("nan")
