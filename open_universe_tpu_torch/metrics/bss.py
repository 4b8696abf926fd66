"""SDR / SI-SDR (replacing the reference's fast_bss_eval dependency; the
port's copy of the JAX package's ``metrics/bss.py``).

si_sdr: standard scale-invariant SDR.
sdr: CI-SDR — SDR with an optimal short FIR distortion filter (length 512,
matching fast_bss_eval's default), solved with a Toeplitz system.
"""
from __future__ import annotations

import numpy as np
from scipy.linalg import solve_toeplitz


def si_sdr(ref: np.ndarray, est: np.ndarray, zero_mean: bool = False,
           clamp_db: float = 100.0) -> float:
    ref = np.asarray(ref, np.float64).reshape(-1)
    est = np.asarray(est, np.float64).reshape(-1)
    if zero_mean:
        ref = ref - ref.mean()
        est = est - est.mean()
    alpha = np.dot(est, ref) / np.maximum(np.dot(ref, ref), 1e-12)
    target = alpha * ref
    noise = est - target
    num = np.dot(target, target)
    den = np.maximum(np.dot(noise, noise), 1e-12)
    val = 10.0 * np.log10(np.maximum(num / den, 1e-12))
    return float(np.clip(val, -clamp_db, clamp_db))


def sdr(ref: np.ndarray, est: np.ndarray, filter_length: int = 512,
        zero_mean: bool = False, clamp_db: float = 100.0) -> float:
    """CI-SDR: project est onto {h * ref : |h| <= filter_length}."""
    ref = np.asarray(ref, np.float64).reshape(-1)
    est = np.asarray(est, np.float64).reshape(-1)
    if zero_mean:
        ref = ref - ref.mean()
        est = est - est.mean()
    n = len(ref)
    L = min(filter_length, n)
    # autocorrelation of ref (first L lags) and cross-correlation with est
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    r_f = np.fft.rfft(ref, nfft)
    e_f = np.fft.rfft(est, nfft)
    acf = np.fft.irfft(r_f * np.conj(r_f), nfft)[:L]
    xcf = np.fft.irfft(e_f * np.conj(r_f), nfft)[:L]
    acf[0] += 1e-9 * max(acf[0], 1e-12)  # diagonal loading
    h = solve_toeplitz((acf, acf), xcf)
    # energy of the projection: h^T xcf ; error = ||est||^2 - proj
    proj = float(np.dot(h, xcf))
    e_total = float(np.dot(est, est))
    noise = max(e_total - proj, 1e-12)
    val = 10.0 * np.log10(max(proj, 1e-12) / noise)
    return float(np.clip(val, -clamp_db, clamp_db))
