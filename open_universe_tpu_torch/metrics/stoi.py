"""STOI and extended STOI (ESTOI), self-contained numpy implementation (the
port's copy of the JAX package's ``metrics/stoi.py``).

Replaces the reference's pystoi dependency.  Implements:
  * Taal et al., "An Algorithm for Intelligibility Prediction of
    Time-Frequency Weighted Noisy Speech", TASLP 2011 (STOI)
  * Jensen & Taal, "An Algorithm for Predicting the Intelligibility of
    Speech Masked by Modulated Noise Maskers", TASLP 2016 (ESTOI)

Pipeline: resample to 10 kHz -> remove silent frames (40 dB range) ->
STFT (256-sample frames, 50% overlap, 512-point FFT) -> 15 third-octave
bands from 150 Hz -> 30-frame segments -> clipped correlation (STOI) or
row/column-normalized segment correlation (ESTOI).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

FS = 10000
N_FRAME = 256
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N = 30  # segment length in frames
BETA = -15.0  # lower SDR bound (dB)
DYN_RANGE = 40.0


def _resample(x: np.ndarray, fs: int, new_fs: int) -> np.ndarray:
    if fs == new_fs:
        return x
    from scipy.signal import resample_poly

    g = math.gcd(fs, new_fs)
    return resample_poly(x, new_fs // g, fs // g)


def _hann(n):
    # matlab-style hanning(n): symmetric, without zero endpoints
    return np.hanning(n + 2)[1:-1]


def _frames(x, flen, hop):
    n = (len(x) - flen) // hop + 1
    idx = np.arange(flen)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


def _remove_silent_frames(x, y, dyn_range=DYN_RANGE, flen=N_FRAME,
                          hop=N_FRAME // 2):
    if len(x) < flen:  # not even one frame; caller handles the short case
        return np.zeros(0), np.zeros(0)
    w = _hann(flen)
    xf = _frames(x, flen, hop) * w
    yf = _frames(y, flen, hop) * w
    energies = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    mask = energies > (np.max(energies) - dyn_range)
    xf, yf = xf[mask], yf[mask]
    # overlap-add back
    n_out = (len(xf) - 1) * hop + flen if len(xf) else 0
    xs = np.zeros(n_out)
    ys = np.zeros(n_out)
    for i in range(len(xf)):
        xs[i * hop : i * hop + flen] += xf[i]
        ys[i * hop : i * hop + flen] += yf[i]
    return xs, ys


@lru_cache(maxsize=1)
def _octave_band_matrix():
    f = np.linspace(0, FS / 2, NFFT // 2 + 1)
    k = np.arange(NUM_BANDS, dtype=np.float64)
    cf = MIN_FREQ * 2.0 ** (k / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    obm = np.zeros((NUM_BANDS, len(f)))
    for i in range(NUM_BANDS):
        li = int(np.argmin((f - lo[i]) ** 2))
        hi_i = int(np.argmin((f - hi[i]) ** 2))
        obm[i, li:hi_i] = 1.0
    return obm


def _band_spectrogram(x):
    w = _hann(N_FRAME)
    xf = _frames(x, N_FRAME, N_FRAME // 2) * w
    spec = np.fft.rfft(xf, NFFT, axis=1)  # (frames, freq)
    power = np.abs(spec) ** 2
    obm = _octave_band_matrix()
    return np.sqrt(power @ obm.T).T  # (bands, frames)


def _segments(a):
    """(bands, frames) -> (n_seg, bands, N)."""
    n_seg = a.shape[1] - N + 1
    return np.stack([a[:, i : i + N] for i in range(n_seg)], axis=0)


def stoi(ref: np.ndarray, est: np.ndarray, fs: int,
         extended: bool = False) -> float:
    """STOI / ESTOI of est against clean ref."""
    ref = np.asarray(ref, np.float64).reshape(-1)
    est = np.asarray(est, np.float64).reshape(-1)
    if len(ref) != len(est):
        raise ValueError("inputs must have the same length")
    ref = _resample(ref, fs, FS)
    est = _resample(est, fs, FS)
    ref, est = _remove_silent_frames(ref, est)
    if len(ref) < N_FRAME + (N - 1) * (N_FRAME // 2):
        # pystoi (the dependency this replaces) warns and returns 1e-5 here
        # rather than raising — one short/mostly-silent clip must not abort
        # a whole metrics sweep
        import warnings

        warnings.warn("signal too short after silence removal; "
                      "returning 1e-5", RuntimeWarning)
        return 1e-5
    X = _band_spectrogram(ref)
    Y = _band_spectrogram(est)
    Xs = _segments(X)  # (S, bands, N)
    Ys = _segments(Y)

    if extended:
        # row normalization (per band over the segment)
        def norm_rows(a):
            a = a - a.mean(axis=2, keepdims=True)
            return a / (np.linalg.norm(a, axis=2, keepdims=True) + 1e-12)

        def norm_cols(a):
            a = a - a.mean(axis=1, keepdims=True)
            return a / (np.linalg.norm(a, axis=1, keepdims=True) + 1e-12)

        Xn = norm_cols(norm_rows(Xs))
        Yn = norm_cols(norm_rows(Ys))
        d = np.sum(Xn * Yn, axis=1) / N  # (S, N) column dots / N
        return float(np.mean(np.sum(d, axis=1)))

    # STOI: per-segment band normalization + clipping
    alpha = np.linalg.norm(Xs, axis=2, keepdims=True) / (
        np.linalg.norm(Ys, axis=2, keepdims=True) + 1e-12)
    Yp = Ys * alpha
    clip_val = Xs * (1.0 + 10.0 ** (-BETA / 20.0))
    Yp = np.minimum(Yp, clip_val)
    xm = Xs - Xs.mean(axis=2, keepdims=True)
    ym = Yp - Yp.mean(axis=2, keepdims=True)
    num = np.sum(xm * ym, axis=2)
    den = np.linalg.norm(xm, axis=2) * np.linalg.norm(ym, axis=2) + 1e-12
    return float(np.mean(num / den))
