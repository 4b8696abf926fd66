"""In-training metric wrapper (reference metrics/eval.py; the port's copy of
the JAX package's ``metrics/eval.py``).

Computes LSD always (torch, on the device of the batch it is given) and PESQ
always (the external pesq package when installed, the in-house P.862
otherwise — metrics/p862.py), so the reference's val/pesq
checkpoint-selection signal (universe.py:706-720, model/default.yaml:73-74)
is there without optional dependencies.  DNSMOS runs when its weights are
found, otherwise it is skipped with a warning.  LPS (``lps=True``) runs its
wav2vec2 model on the card unless ``device`` names another.
"""
from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np
import torch

from ..data.audio import resample_audio
from .lsd import log_spectral_distance

log = logging.getLogger(__name__)


class EvalMetrics:
    def __init__(self, pesq_mode: str = "wb", lps: bool = False,
                 audio_fs: int = 16000, dnsmos: bool = True, device=None):
        self.mode = pesq_mode
        self.eval_fs = 16000
        self.audio_fs = audio_fs

        from .p862 import resolve_pesq

        self._pesq, _ = resolve_pesq()

        self._dnsmos = None
        if dnsmos:
            try:
                from .dnsmos import Compute_DNSMOS

                self._dnsmos = Compute_DNSMOS()
            except Exception as e:
                log.warning("DNSMOS unavailable (%s); val/dnsmos-* skipped", e)

        self._lps = None
        if lps:
            from .lps import LevenshteinPhonemeSimilarity

            self._lps = LevenshteinPhonemeSimilarity(device=device)

    def __call__(self, est, ref) -> dict:
        """est/ref: (B, 1, T) or (B, T) tensors (LSD runs on their device)
        or arrays; returns a dict of scalars."""
        est = torch.as_tensor(est)
        ref = torch.as_tensor(ref, device=est.device)
        if est.dim() == 2:
            est = est[:, None]
            ref = ref[:, None]

        metrics = {"lsd": float(torch.mean(log_spectral_distance(est, ref)))}

        est = est.detach().cpu().numpy()
        ref = ref.detach().cpu().numpy()
        if self.eval_fs != self.audio_fs:
            est = resample_audio(est, self.audio_fs, self.eval_fs)
            ref = resample_audio(ref, self.audio_fs, self.eval_fs)

        # per-metric error isolation: one metric failing on a sample (e.g.
        # PESQ on a near-silent clip) must not drop the OTHER metrics for
        # that sample, or their means silently cover different sample sets
        def _try(name, fn, ii):
            try:
                return fn()
            except Exception as e:
                log.debug("%s failed on sample %d: %s", name, ii, e)
                return None

        lists = defaultdict(list)
        for ii in range(est.shape[0]):
            if self._pesq is not None:
                v = _try("pesq", lambda: self._pesq(
                    self.eval_fs, ref[ii, 0], est[ii, 0], self.mode), ii)
                if v is not None:
                    lists["pesq"].append(v)
            if self._lps is not None:
                v = _try("lps", lambda: self._lps(est[ii, 0], ref[ii, 0]), ii)
                if v is not None:
                    lists["lps"].append(v)
            if self._dnsmos is not None:
                d = _try("dnsmos",
                         lambda: self._dnsmos(est[ii, 0], self.eval_fs), ii)
                if d is not None:
                    for lbl in ("OVRL", "SIG", "BAK"):
                        lists["dnsmos-" + lbl].append(d[lbl])

        for met, vals in lists.items():
            metrics[met] = float(np.mean(vals))
        return metrics
