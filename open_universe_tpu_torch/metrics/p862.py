"""In-house PESQ (ITU-T P.862 family) — pure numpy/scipy, no external deps.

The port's copy of the JAX package's ``metrics/p862.py`` (numpy only).
Drop-in fallback for the ``pesq`` package used by the reference
(its ``metrics/pesq.py:26-80`` and ``metrics/wrapper.py:108-125``): exposes ``pesq(fs, ref, deg, mode)``
returning MOS-LQO, with ``mode`` in {"wb", "nb"}.

Algorithm structure follows ITU-T P.862 (narrowband) / P.862.2 (wideband):

1. per-signal level alignment to a fixed active-band power (350-3250 Hz
   bandpass estimate, target 1e7),
2. input filtering (WB: the P.862.2 high-pass IIR; NB: IRS receive
   characteristic applied as an FFT gain mask),
3. time alignment (envelope crude align + sample-level refinement; a single
   constant delay per file, which covers the speech-enhancement use case —
   the per-utterance delay splitting of P.862 for VoIP-style time-varying
   delay is intentionally not implemented),
4. perceptual model: Hann-framed power spectra -> Bark-band pitch power
   densities -> partial frequency-response compensation of the reference ->
   smoothed short-term gain compensation of the degraded signal -> Zwicker
   loudness transform -> symmetric + asymmetric disturbance densities with
   deadzone and asymmetry factor,
5. aggregation: width-weighted L2 (sym) / L1 (asym) across Bark bands,
   L6 across 20-frame split-second windows (50% overlap), L2 across windows,
   low-power frame deweighting, cap at 45,
6. raw score 4.5 - 0.1*d_sym - 0.0309*d_asym, mapped to MOS-LQO with the
   published logistics (P.862.1 for NB, P.862.2 for WB).

CONFORMANCE NOTE: the ITU's hand-tuned Bark band tables and absolute
threshold tables are not redistributable from memory; this implementation
derives the critical-band layout from the Zwicker-Terhardt bark scale and
the absolute hearing threshold from Terhardt's threshold-in-quiet formula,
calibrated to P.862's 79 dB SPL listening-level convention. Scores are
strongly rank-correlated with conformant PESQ and exact for the
identical-signal fixed points (4.64 WB / 4.55 NB), but are NOT bit-exact
ITU values. When the external ``pesq`` package is installed it is preferred
everywhere (see metrics/pesq.py, metrics/wrapper.py, metrics/eval.py).
"""
from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

# ---------------------------------------------------------------------------
# Constants (P.862 / P.862.2)
# ---------------------------------------------------------------------------

TARGET_AVG_POWER = 1e7  # level-alignment target for active speech power

# piecewise-linear |H| in dB over Hz used by the level-alignment bandpass
# (flat 350-3250 Hz, steep roll-off outside)
_ALIGN_FILTER_DB = np.array([
    [0, -500], [50, -500], [100, -500], [125, -500], [160, -500],
    [200, -500], [250, -500], [300, -500], [350, 0], [400, 0],
    [500, 0], [600, 0], [630, 0], [800, 0], [1000, 0], [1250, 0],
    [1600, 0], [2000, 0], [2500, 0], [3000, 0], [3250, 0],
    [3500, -500], [4000, -500], [5000, -500], [6300, -500], [8000, -500],
], dtype=np.float64)

# IRS receive characteristic (NB input filter), |H| in dB over Hz
_IRS_FILTER_DB = np.array([
    [0, -200], [50, -40], [100, -20], [125, -12], [160, -6], [200, 0],
    [250, 4], [300, 6], [350, 8], [400, 10], [500, 11], [600, 12],
    [700, 12], [800, 12], [1000, 12], [1300, 12], [1600, 12], [2000, 12],
    [2500, 12], [3000, 12], [3250, 12], [3500, 4], [4000, -200],
    [5000, -200], [6300, -200], [8000, -200],
], dtype=np.float64)

# P.862.2 wideband input filter: single high-pass biquad (b, a)
_WB_IIR_B = np.array([2.6657628, -5.3315255, 2.6657628])
_WB_IIR_A = np.array([1.0, -1.8890331, 0.89487434])

_SL = 1.866055e-1       # loudness scaling
_ZWICKER_POWER = 0.23

_D_WEIGHT = 0.1         # symmetric disturbance weight in raw MOS
_A_WEIGHT = 0.0309      # asymmetric disturbance weight in raw MOS
_SPLIT_LEN = 20         # frames per split-second window
_SPLIT_HOP = 10


def _bark(f):
    """Zwicker-Terhardt Hz -> Bark."""
    f = np.asarray(f, dtype=np.float64)
    return 13.0 * np.arctan(7.6e-4 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _threshold_in_quiet_db(f):
    """Terhardt absolute hearing threshold in dB SPL."""
    f = np.maximum(np.asarray(f, dtype=np.float64), 20.0)
    khz = f / 1000.0
    return (3.64 * khz ** -0.8
            - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
            + 1e-3 * khz ** 4)


class _BandLayout:
    """Bark-band layout for one sample rate: FFT-bin grouping + thresholds."""

    def __init__(self, fs: int):
        if fs == 16000:
            self.nfft, nb, f_hi = 1024, 49, 7625.0
        elif fs == 8000:
            self.nfft, nb, f_hi = 512, 42, 3800.0
        else:
            raise ValueError(f"PESQ requires fs of 8000 or 16000, got {fs}")
        self.fs = fs
        self.nb = nb
        edges_bark = np.linspace(_bark(25.0), _bark(f_hi), nb + 1)
        freqs = np.arange(self.nfft // 2 + 1) * (fs / self.nfft)
        bins_bark = _bark(freqs)
        # band index per rfft bin; bins outside [lo, hi) are dropped
        self.band_of_bin = np.digitize(bins_bark, edges_bark) - 1
        self.valid = (self.band_of_bin >= 0) & (self.band_of_bin < nb)
        centre_bark = 0.5 * (edges_bark[:-1] + edges_bark[1:])
        self.width_bark = np.diff(edges_bark)
        # band centre in Hz by inverting the bark map on a fine grid
        grid = np.linspace(1.0, fs / 2, 16384)
        self.centre_hz = np.interp(centre_bark, _bark(grid), grid)
        self.centre_bark = centre_bark
        # calibration: average active speech power 1e7 (internal units)
        # corresponds to the 79 dB SPL listening level of P.862
        spl_offset = 79.0 - 10.0 * np.log10(TARGET_AVG_POWER)
        self.abs_thresh = 10.0 ** (
            (_threshold_in_quiet_db(self.centre_hz) - spl_offset) / 10.0)
        # modified Zwicker exponent (larger for low bands)
        h = np.minimum(6.0 / (centre_bark + 2.0), 2.0)
        h = np.maximum(h, 1.0) ** 0.15
        self.zwicker = _ZWICKER_POWER * h

    def group(self, power_spectrum):
        """Sum rfft-bin powers (frames, nfft//2+1) into bands (frames, nb)."""
        out = np.zeros((power_spectrum.shape[0], self.nb))
        np.add.at(out.T, self.band_of_bin[self.valid],
                  power_spectrum[:, self.valid].T)
        return out


_LAYOUTS: dict[int, _BandLayout] = {}


def _layout(fs: int) -> _BandLayout:
    if fs not in _LAYOUTS:
        _LAYOUTS[fs] = _BandLayout(fs)
    return _LAYOUTS[fs]


# ---------------------------------------------------------------------------
# Pre-processing
# ---------------------------------------------------------------------------

def _fft_gain_filter(x, fs, table_db):
    """Apply a piecewise-linear-in-dB magnitude response via one big FFT."""
    n = len(x)
    nfft = 1 << max(int(np.ceil(np.log2(max(n, 2)))), 6)
    freqs = np.arange(nfft // 2 + 1) * (fs / nfft)
    gain_db = np.interp(freqs, table_db[:, 0], table_db[:, 1])
    gain = 10.0 ** (gain_db / 20.0)
    spec = np.fft.rfft(x, nfft)
    return np.fft.irfft(spec * gain, nfft)[:n]


def _band_fraction(x, fs):
    """(band power, total power) for the 350-3250 Hz alignment band."""
    band = _fft_gain_filter(x, fs, _ALIGN_FILTER_DB)
    return float(np.mean(band ** 2)), float(np.mean(np.asarray(x) ** 2))


def _fix_power_level(x, use_band: bool, powers):
    """Scale so the alignment band (or, with use_band=False, the full band)
    has average power TARGET_AVG_POWER.

    Degenerate (non-speech) inputs with almost no energy in the 350-3250 Hz
    band — e.g. a pure tone below 350 Hz, whose only in-band content is
    spectral-leakage skirts — would be blown up by a huge scale factor.
    ``pesq_raw`` decides use_band ONCE for the (ref, deg) pair (both signals
    must be aligned by the same rule, or their relative level is skewed) and
    passes the already-computed (p_band, p_tot) here — _band_fraction runs a
    full-signal FFT filter, so recomputing it would double that cost per
    clip."""
    p_band, p_tot = powers
    p = p_band if use_band else p_tot
    if p <= 0:
        p = p_tot
    if p <= 0:
        return x
    return x * np.sqrt(TARGET_AVG_POWER / p)


def _estimate_delay(ref, deg, fs):
    """Constant delay of deg relative to ref (samples), envelope + refine."""
    hop = max(fs // 250, 1)  # 4 ms envelope resolution
    n = min(len(ref), len(deg)) // hop * hop
    if n < 4 * hop:
        return 0
    env_r = np.log1p(np.abs(ref[:n]).reshape(-1, hop).mean(axis=1))
    env_d = np.log1p(np.abs(deg[:n]).reshape(-1, hop).mean(axis=1))
    env_r = env_r - env_r.mean()
    env_d = env_d - env_d.mean()
    m = len(env_r)
    nfft = 1 << int(np.ceil(np.log2(2 * m)))
    xc = np.fft.irfft(np.fft.rfft(env_d, nfft)
                      * np.conj(np.fft.rfft(env_r, nfft)), nfft)
    lags = np.concatenate([np.arange(m), np.arange(-m + 1, 0)])
    order = np.argsort(np.concatenate([xc[:m], xc[nfft - m + 1:]]))
    crude = int(lags[order[-1]]) * hop
    # sample-level refinement around the crude estimate
    win = 2 * hop
    lo, hi = crude - win, crude + win
    best, best_val = crude, -np.inf
    for lag in range(lo, hi + 1):
        if lag >= 0:
            a, b = ref[: n - lag], deg[lag:n]
        else:
            a, b = ref[-lag:n], deg[: n + lag]
        if len(a) < fs // 10:
            continue
        v = float(np.dot(a, b))
        if v > best_val:
            best_val, best = v, lag
    return best


def _apply_delay(ref, deg, delay):
    if delay > 0:
        deg = deg[delay:]
    elif delay < 0:
        ref = ref[-delay:]
    n = min(len(ref), len(deg))
    return ref[:n], deg[:n]


# ---------------------------------------------------------------------------
# Perceptual model
# ---------------------------------------------------------------------------

def _frame_band_powers(x, layout):
    """Hann-framed band powers; sum over bands ~= frame mean-square power."""
    nf = layout.nfft
    hop = nf // 2
    n_frames = max((len(x) - nf) // hop + 1, 0)
    if n_frames == 0:
        x = np.pad(x, (0, nf - len(x)))
        n_frames = 1
    idx = np.arange(nf)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx]
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(nf) / nf))
    spec = np.fft.rfft(frames * w[None, :], axis=1)
    pw = np.abs(spec) ** 2
    pw[:, 1:-1] *= 2.0
    pw /= nf * np.sum(w ** 2)
    return layout.group(pw)


def _loudness(pitch_pow, layout):
    t = layout.abs_thresh[None, :]
    g = layout.zwicker[None, :]
    loud = _SL * (t / 0.5) ** g * ((0.5 + 0.5 * pitch_pow / t) ** g - 1.0)
    return np.where(pitch_pow > t, loud, 0.0)


def _pseudo_lp(x, widths, p):
    """P.862 width-weighted band norm: W * (sum((|x|*w)^p)/W)^(1/p)."""
    total_w = float(np.sum(widths))
    s = np.sum((np.abs(x) * widths[None, :]) ** p, axis=1)
    return total_w * (s / total_w) ** (1.0 / p)


def _lpq_time(frame_vals, p_split=6.0, q_time=2.0):
    """L_p over 20-frame split-second windows (50% ovl), L_q across them."""
    n = len(frame_vals)
    if n == 0:
        return 0.0
    vals = []
    start = 0
    while start < n:
        seg = frame_vals[start:start + _SPLIT_LEN]
        vals.append(np.mean(seg ** p_split) ** (1.0 / p_split))
        start += _SPLIT_HOP
    vals = np.asarray(vals)
    return float(np.mean(vals ** q_time) ** (1.0 / q_time))


def _perceptual_model(ref, deg, fs):
    layout = _layout(fs)
    ppr = _frame_band_powers(ref, layout)
    ppd = _frame_band_powers(deg, layout)
    n_frames = min(ppr.shape[0], ppd.shape[0])
    ppr, ppd = ppr[:n_frames], ppd[:n_frames]

    total_ref = ppr.sum(axis=1)
    active = total_ref > TARGET_AVG_POWER * 1e-3  # 30 dB below nominal

    # partial frequency-response compensation of the reference
    if np.any(active):
        avg_r = ppr[active].mean(axis=0)
        avg_d = ppd[active].mean(axis=0)
    else:
        avg_r = ppr.mean(axis=0)
        avg_d = ppd.mean(axis=0)
    corr = np.clip((avg_d + 1000.0) / (avg_r + 1000.0), 0.01, 100.0)
    ppr_eq = ppr * corr[None, :]

    # smoothed short-term gain compensation of the degraded signal
    thr = layout.abs_thresh[None, :]
    aud_r = np.where(ppr_eq > thr, ppr_eq, 0.0).sum(axis=1)
    aud_d = np.where(ppd > thr, ppd, 0.0).sum(axis=1)
    gains = np.empty(n_frames)
    g = 1.0
    for i in range(n_frames):
        h = (aud_r[i] + 5e3) / (aud_d[i] + 5e3)
        g = h if i == 0 else 0.8 * g + 0.2 * h
        gains[i] = np.clip(g, 3e-4, 5.0)
    ppd_eq = ppd * gains[:, None]

    loud_r = _loudness(ppr_eq, layout)
    loud_d = _loudness(ppd_eq, layout)

    # symmetric disturbance with deadzone
    d = loud_d - loud_r
    m = 0.25 * np.minimum(loud_d, loud_r)
    disturbance = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)

    # asymmetric disturbance: penalize additive components
    ratio = ((ppd + 50.0) / (ppr_eq + 50.0)) ** 1.2
    asym = np.where(ratio < 3.0, 0.0, np.minimum(ratio, 12.0))
    asym_disturbance = disturbance * asym

    d_frame = _pseudo_lp(disturbance, layout.width_bark, 2.0)
    a_frame = np.sum(np.abs(asym_disturbance) * layout.width_bark[None, :],
                     axis=1)

    # deweight low-power frames, cap at 45
    weight = ((total_ref + 1e5) / 1e7) ** 0.04
    d_frame = np.minimum(d_frame / weight, 45.0)
    a_frame = np.minimum(a_frame / weight, 45.0)

    d_sym = _lpq_time(d_frame)
    d_asym = _lpq_time(a_frame)
    return 4.5 - _D_WEIGHT * d_sym - _A_WEIGHT * d_asym


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def pesq_raw(fs: int, ref, deg, mode: str = "wb") -> float:
    """Raw P.862 score (pre-mapping), same preprocessing as ``pesq``."""
    ref = np.asarray(ref, dtype=np.float64).reshape(-1)
    deg = np.asarray(deg, dtype=np.float64).reshape(-1)
    if mode == "wb" and fs != 16000:
        raise ValueError("wb mode requires fs=16000")
    if mode == "nb" and fs not in (8000, 16000):
        raise ValueError("nb mode requires fs of 8000 or 16000")
    if min(len(ref), len(deg)) < fs // 4:
        raise ValueError("signals too short for PESQ (< 0.25 s)")

    # one joint rule for the pair: band-power alignment only when BOTH
    # signals have real energy in the alignment band (speech always does;
    # the guard targets degenerate tones/noise outside 350-3250 Hz)
    pb_r, pt_r = _band_fraction(ref, fs)
    pb_d, pt_d = _band_fraction(deg, fs)
    use_band = (pb_r > 1e-2 * pt_r) and (pb_d > 1e-2 * pt_d)
    ref = _fix_power_level(ref, use_band, (pb_r, pt_r))
    deg = _fix_power_level(deg, use_band, (pb_d, pt_d))

    if mode == "wb":
        ref = lfilter(_WB_IIR_B, _WB_IIR_A, ref)
        deg = lfilter(_WB_IIR_B, _WB_IIR_A, deg)
    else:
        ref = _fft_gain_filter(ref, fs, _IRS_FILTER_DB)
        deg = _fft_gain_filter(deg, fs, _IRS_FILTER_DB)

    delay = _estimate_delay(ref, deg, fs)
    ref, deg = _apply_delay(ref, deg, delay)
    return float(_perceptual_model(ref, deg, fs))


def pesq(fs: int, ref, deg, mode: str = "wb") -> float:
    """MOS-LQO, signature-compatible with ``pesq.pesq`` from the package."""
    raw = pesq_raw(fs, ref, deg, mode)
    if mode == "wb":
        return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))
    return 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))


def resolve_pesq():
    """Prefer the conformant external ``pesq`` package; fall back to this
    module. Returns ``(fn, conformant)`` with fn(fs, ref, deg, mode)."""
    try:
        from pesq import pesq as _ext

        return _ext, True
    except ImportError:
        import logging

        logging.getLogger(__name__).info(
            "pesq package unavailable; using the in-house P.862 "
            "implementation (non-conformant, see metrics/p862.py)")
        return pesq, False
