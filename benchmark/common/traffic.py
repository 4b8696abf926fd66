"""The general traffic generator: arrivals, lengths and speech-like clips
from a traffic file's parameters and the run's seed (numpy only).

The seed changes the order of the work, never its amount: the gaps between
arrivals and the clip lengths are fixed quantiles of their distributions
(an exponential for Poisson arrivals, a log-normal cut to [min_s, max_s] for
lengths), and the seed draws their order and each clip's content.  So every
seed offers the same number of requests and seconds of audio, and runs with
different seeds spread no wider than runs of one seed.

Arrivals may come in bursts: ``burst_on_s`` seconds at rate x (on + off) /
on, then ``burst_off_s`` seconds of silence, which keeps the mean rate.
"""
from __future__ import annotations

import io
import wave
from statistics import NormalDist
from typing import List, Tuple

import numpy as np

WAVETABLE = 4096


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def schedule(arrivals: dict, lengths: dict, seconds: float, fs: int,
             seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(due times in s from the window's start, clip lengths in samples) of
    the requests of one window of ``seconds``."""
    rate = float(arrivals["rate_per_s"])
    n = max(1, int(round(rate * seconds)))
    q = _quantiles(n)
    gaps = -np.log1p(-q)
    on, off = float(arrivals.get("burst_on_s", 0.0)), float(arrivals.get("burst_off_s", 0.0))
    active = seconds * on / (on + off) if on > 0 else seconds
    gaps *= active / gaps.sum()
    rng = np.random.default_rng([seed, 0])
    gaps = rng.permutation(gaps)
    due = np.cumsum(gaps) - gaps
    if on > 0:
        cycles = np.floor(due / on)
        due = cycles * (on + off) + (due - cycles * on)
    z = np.array([NormalDist().inv_cdf(p) for p in q])
    secs = np.clip(lengths["median_s"] * np.exp(lengths["sigma"] * z),
                   lengths["min_s"], lengths["max_s"])
    samples = np.round(rng.permutation(secs) * fs).astype(np.int64)
    return due, samples


def _harmonic_table() -> np.ndarray:
    k = np.arange(1, 25)[:, None]
    ph = 2 * np.pi * np.arange(WAVETABLE)[None, :] / WAVETABLE
    table = np.sum(np.sin(k * ph) / k, axis=0)
    return (table / np.sqrt(np.mean(table ** 2))).astype(np.float32)


_TABLE = _harmonic_table()


def speech_like(n: int, fs: int, rng: np.random.Generator) -> np.ndarray:
    """One clip of n samples in [-1, 1], float32: a 24-harmonic voice whose
    pitch (90-250 Hz) glides, gated at a syllable rate of 3-5 Hz, in white
    noise at 0-15 dB SNR, at -35 to -20 dBFS."""
    t = np.arange(n, dtype=np.float64) / fs
    f0 = rng.uniform(90, 250) * (1 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * t
                                                   + rng.uniform(0, 2 * np.pi)))
    phase = np.cumsum(f0) / fs
    voice = _TABLE[((phase % 1.0) * WAVETABLE).astype(np.int64)]
    gate = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t + rng.uniform(0, 2 * np.pi))
    voice = voice * gate ** 2
    voice /= max(np.sqrt(np.mean(voice ** 2)), 1e-6)
    noise = rng.standard_normal(n) * 10 ** (-rng.uniform(0, 15) / 20)
    x = voice + noise
    x *= 10 ** (rng.uniform(-35, -20) / 20) / np.sqrt(np.mean(x ** 2))
    peak = np.max(np.abs(x))
    if peak > 0.99:
        x *= 0.99 / peak
    return x.astype(np.float32)


def clip(seed: int, index: int, n: int, fs: int) -> np.ndarray:
    """Request (or row) ``index``'s clip of a run with ``seed``."""
    return speech_like(int(n), fs, np.random.default_rng([seed, 1, int(index)]))


def pcm16(x: np.ndarray) -> np.ndarray:
    """16-bit PCM of a float clip (what the WAV body carries)."""
    return np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16)


def wav_bytes(pcm: np.ndarray, fs: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def wav_pcm(body: bytes) -> np.ndarray:
    """The int16 samples of a mono 16-bit WAV body."""
    with wave.open(io.BytesIO(body)) as w:
        if w.getnchannels() != 1 or w.getsampwidth() != 2:
            raise ValueError("expected mono 16-bit PCM")
        return np.frombuffer(w.readframes(w.getnframes()), np.int16).copy()


def offline_batches(seed: int, n_batches: int, rows: int, n: int, fs: int) -> List[np.ndarray]:
    """``n_batches`` distinct (rows, n) float32 batches of clips."""
    return [np.stack([clip(seed, b * rows + r, n, fs) for r in range(rows)])
            for b in range(n_batches)]
