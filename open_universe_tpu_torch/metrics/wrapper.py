"""Offline metrics dispatcher (reference metrics/wrapper.py; the port's copy
of the JAX package's ``metrics/wrapper.py``, its LSD in torch on the CPU).

Same metric surface as the reference: pesq-wb, pesq-nb, stoi, stoi-ext, lsd,
si-lsd, lps, dnsmos, plcmos, sdr, si-sdr.  Metrics with optional external
dependencies (pesq lib, onnxruntime, the DNSMOS/PLCMOS weights, the
wav2vec2 espeak checkpoint of ``lps``) raise a clear error at construction
if requested but unavailable.  ``lps`` runs its wav2vec2 model on the card
unless ``device`` names another.
"""
from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.audio import resample_audio
from .bss import sdr as _sdr, si_sdr as _si_sdr
from .lsd import log_spectral_distance
from .stoi import stoi as _stoi

log = logging.getLogger(__name__)

_ALL_METRICS = ["pesq-wb", "pesq-nb", "stoi", "stoi-ext", "lsd", "si-lsd",
                "lps", "dnsmos", "plcmos", "sdr", "si-sdr"]


def _cached_resample(orig_fs, new_fs, cache, **signals):
    out = {}
    for label, signal in signals.items():
        if not (new_fs in cache and label in cache[new_fs]):
            cache[new_fs][label] = resample_audio(signal, orig_fs, new_fs)
        out[label] = cache[new_fs][label]
    return out, cache


def pesq_available() -> bool:
    try:
        import pesq  # noqa: F401

        return True
    except ImportError:
        return False


# result keys each metric emits (used for rerun skipping); metrics not
# listed emit exactly their own name
_METRIC_KEYS = {
    "dnsmos": ("OVRL_raw", "SIG_raw", "BAK_raw", "OVRL", "SIG", "BAK"),
}


class Metrics:
    """Dispatcher: Metrics(["pesq-wb", "si-sdr"])(fs, degraded, reference)."""

    @classmethod
    def get_metric_names(cls) -> List[str]:
        return list(_ALL_METRICS)

    @classmethod
    def metric_keys(cls, met: str):
        return _METRIC_KEYS.get(met, (met,))

    @classmethod
    def remaining(cls, metrics: Sequence[str], skip_list) -> List[str]:
        """Metrics whose emitted keys are not all already in skip_list.
        Matching on the EMITTED keys rather than the metric name means
        dnsmos (emits OVRL/SIG/BAK...) is correctly skipped on rerun —
        the reference's `met in skip_list` recomputes it every time
        (reference wrapper.py:263)."""
        skip = set(skip_list or ())
        return [m for m in metrics if not set(cls.metric_keys(m)) <= skip]

    def __init__(self, metrics: Optional[Sequence[str]] = None, device=None):
        if metrics is None:
            metrics = list(_ALL_METRICS)
        for met in metrics:
            if met not in _ALL_METRICS:
                raise NotImplementedError(f"metric {met} is not supported")
        self.metrics = list(metrics)

        if any(m.startswith("pesq") for m in self.metrics):
            from .p862 import resolve_pesq

            self._pesq, self._pesq_conformant = resolve_pesq()
        if "dnsmos" in self.metrics:
            from .dnsmos import Compute_DNSMOS

            self._dnsmos = Compute_DNSMOS()
        if "plcmos" in self.metrics:
            from .plcmos import PLCMOSEstimator

            self._plcmos = PLCMOSEstimator()
        if "lps" in self.metrics:
            from .lps import LevenshteinPhonemeSimilarity

            self._lps = LevenshteinPhonemeSimilarity(device=device)

    # ---- individual metrics (each: (ref, deg, fs, cache) -> (dict, cache))
    def _pesq_base(self, ref, deg, fs, mode, cache):
        sig, cache = _cached_resample(fs, 16000, cache, ref=ref, deg=deg)
        return self._pesq(16000, sig["ref"], sig["deg"], mode), cache

    def pesq_wb(self, ref, deg, fs, cache):
        if ref is None:
            return {}, cache
        val, cache = self._pesq_base(ref, deg, fs, "wb", cache)
        return {"pesq-wb": val}, cache

    def pesq_nb(self, ref, deg, fs, cache):
        if ref is None:
            return {}, cache
        val, cache = self._pesq_base(ref, deg, fs, "nb", cache)
        return {"pesq-nb": val}, cache

    def stoi(self, ref, deg, fs, cache):
        if ref is None:
            return {}, cache
        return {"stoi": _stoi(ref, deg, fs, extended=False)}, cache

    def stoi_ext(self, ref, deg, fs, cache):
        if ref is None:
            return {}, cache
        return {"stoi-ext": _stoi(ref, deg, fs, extended=True)}, cache

    def lsd(self, ref, deg, fs, cache, scale_invariant=False):
        if ref is None:
            return {}, cache
        n_fft = int(0.025 * fs)
        hop = int(0.01 * fs)
        val = log_spectral_distance(torch.as_tensor(deg), torch.as_tensor(ref),
                                    n_fft=n_fft, hop_length=hop,
                                    scale_invariant=scale_invariant)
        return {"lsd": float(torch.mean(val))}, cache

    def si_lsd(self, ref, deg, fs, cache):
        ret, cache = self.lsd(ref, deg, fs, cache, scale_invariant=True)
        if "lsd" in ret:
            ret["si-lsd"] = ret.pop("lsd")
        return ret, cache

    def lps(self, ref, deg, fs, cache):
        if ref is None:
            return {}, cache
        sig, cache = _cached_resample(fs, self._lps.sr, cache, ref=ref, deg=deg)
        return {"lps": float(self._lps(sig["deg"], sig["ref"]))}, cache

    def dnsmos(self, ref, deg, fs, cache):
        sig, cache = _cached_resample(fs, 16000, cache, deg=deg)
        val = self._dnsmos(sig["deg"], 16000)
        return {m: float(val[m]) for m in
                ["OVRL_raw", "SIG_raw", "BAK_raw", "OVRL", "SIG", "BAK"]}, cache

    def plcmos(self, ref, deg, fs, cache):
        sig, cache = _cached_resample(fs, 16000, cache, deg=deg)
        return {"plcmos": float(self._plcmos.run(sig["deg"], 16000))}, cache

    def sdr(self, ref, deg, fs, cache):
        if ref is None:
            return {}, cache
        return {"sdr": _sdr(ref, deg)}, cache

    def si_sdr(self, ref, deg, fs, cache):
        if ref is None:
            return {}, cache
        return {"si-sdr": _si_sdr(ref, deg)}, cache

    def __call__(self, fs, degraded, reference=None, skip_list=None,
                 skip_unknown_metrics=True):
        degraded = np.asarray(degraded)
        if reference is not None:
            reference = np.asarray(reference)
            m = max(reference.shape[-1], degraded.shape[-1])
            degraded = np.pad(degraded, [(0, 0)] * (degraded.ndim - 1)
                              + [(0, m - degraded.shape[-1])])
            reference = np.pad(reference, [(0, 0)] * (reference.ndim - 1)
                               + [(0, m - reference.shape[-1])])
            if reference.shape != degraded.shape:
                raise ValueError("input shapes must match")
        if degraded.ndim > 2:
            raise ValueError("input should have 1 or 2 dimensions")

        single = degraded.ndim == 1
        if single:
            degraded = degraded[None]
            if reference is not None:
                reference = reference[None]
        if reference is None:
            reference = [None] * degraded.shape[0]

        output = []
        for idx in range(degraded.shape[0]):
            cache = defaultdict(dict)
            row: Dict[str, float] = {}
            for met in self.metrics:
                if skip_list is not None and \
                        set(self.metric_keys(met)) <= set(skip_list):
                    continue
                func = getattr(self, met.replace("-", "_"), None)
                if func is None:
                    if skip_unknown_metrics:
                        continue
                    raise ValueError(f"metric {met} not supported")
                try:
                    vals, cache = func(reference[idx], degraded[idx], fs,
                                       cache)
                except Exception as e:
                    # per-metric isolation: one metric failing on a clip
                    # (e.g. PESQ < 0.25 s) must not drop the clip's other
                    # metrics; the failed one stays absent so an incremental
                    # rerun retries exactly it (the reference has no
                    # handling at all here and aborts the whole sweep)
                    log.warning("%s failed: %s", met, e)
                    continue
                row.update(vals)
            output.append(row)

        return output[0] if single else output
