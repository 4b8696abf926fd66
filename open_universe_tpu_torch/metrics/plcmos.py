"""PLCMOS v2 (Microsoft) — ONNX non-intrusive MOS for packet-loss concealment
(the port's copy of the JAX package's ``metrics/plcmos.py``).

Functionality of the reference's vendored plc_mos.py (v2 model only): hamming
512-point log-power STFT features, 15 random rater-embedding rounds.
Requires the model file (resolved like DNSMOS: env var
OPEN_UNIVERSE_PLCMOS_DIR or a local ``plcmos_models`` dir) and runs it on
``onnxruntime`` or, without it, on the port's ``metrics/onnx_exec.py``.
"""
from __future__ import annotations

import math
import os
from pathlib import Path

import numpy as np


def _find_model() -> Path:
    candidates = []
    env = os.environ.get("OPEN_UNIVERSE_PLCMOS_DIR")
    if env:
        candidates.append(Path(env) / "plcmos_v2.onnx")
    here = Path(__file__).parent
    candidates.append(here / "plcmos_models" / "plcmos_v2.onnx")
    for c in candidates:
        if c.exists():
            return c
    raise FileNotFoundError(
        f"plcmos_v2.onnx not found (looked in {candidates}); "
        "set OPEN_UNIVERSE_PLCMOS_DIR")


def _logpow(spec: np.ndarray, floor: float = -120.0) -> np.ndarray:
    log10e = np.log10(np.e)
    pspec = spec.real**2 + spec.imag**2
    zeros = pspec == 0
    logp = np.empty_like(pspec)
    if np.any(~zeros):
        logp[~zeros] = np.log(pspec[~zeros])
        logp[zeros] = np.log(pspec[~zeros].min()) + floor / 10 / log10e
    else:
        logp.fill(-80 / 10 / log10e)
    return logp


def _stft_features(audio: np.ndarray, dft_size: int = 512,
                   hop_fraction: float = 0.5) -> np.ndarray:
    """Hamming-window 'synthesis-aligned' framing (plc_mos.py:103-146)."""
    window = np.hamming(dft_size + 1)[:-1]
    hop = int(dft_size * hop_fraction)
    fsize = dft_size
    sstart = hop - fsize
    ssize = len(audio)
    nframe = math.ceil((ssize - sstart) / hop)
    zpleft = -sstart
    zpright = (nframe - 1) * hop + fsize - zpleft - ssize
    pad = np.zeros(ssize + zpleft + zpright, dtype=np.float64)
    pad[zpleft:len(pad) - zpright if zpright > 0 else len(pad)] = audio
    idx = np.arange(fsize)[None, :] + hop * np.arange(nframe)[:, None]
    frames = pad[idx] * window
    amp = np.abs(np.fft.rfft(frames, n=dft_size))
    return _logpow(amp, floor=-120.0) / 20.0


class PLCMOSEstimator:
    def __init__(self, model_version: int = 2, embed_rounds: int = 15,
                 num_threads=None, session=None):
        """``session`` injects any object with onnxruntime's ``run``
        interface — tests use a stub to exercise the feature pipeline
        without onnxruntime."""
        if str(model_version) != "2":
            raise NotImplementedError("only PLCMOS v2 is supported")
        if session is None:
            try:
                import onnxruntime as ort

                sess_opt = ort.SessionOptions()
                if num_threads is not None:
                    sess_opt.intra_op_num_threads = num_threads
                session = ort.InferenceSession(str(_find_model()), sess_opt)
            except ImportError:
                # without onnxruntime: run the official weights with the
                # in-house executor
                from .onnx_exec import OnnxSession

                session = OnnxSession(str(_find_model()))
        self.session = session
        self.embed_rounds = embed_rounds

    def run(self, audio_degraded: np.ndarray, sr_degraded: int) -> float:
        assert sr_degraded == 16000
        rng = np.random.RandomState(23)
        feats = np.float32(_stft_features(np.asarray(audio_degraded,
                                                     np.float64)))
        feats = feats[np.newaxis, np.newaxis]
        mos = 0.0
        for _ in range(self.embed_rounds):
            rater = rng.normal(size=(1, 64)).astype(np.float32)
            mos += float(self.session.run(
                None, {"degraded_audio": feats, "rater_embed": rater})[0])
        return mos / self.embed_rounds
