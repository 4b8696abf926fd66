"""DNSMOS P.835 (Microsoft) — ONNX-based non-intrusive MOS estimator (the
port's copy of the JAX package's ``metrics/dnsmos.py``).

Functionality of the reference's vendored dnsmos_local.py: 9.01-second
windows hopped by 1 s, the sig_bak_ovr.onnx model, and the published
polynomial calibration.  Requires ``onnxruntime`` and the model file; both
are optional (evaluation-only, off the training path).  The model directory
is resolved from, in order: the OPEN_UNIVERSE_DNSMOS_DIR env var or a
``dnsmos_models`` directory next to this file.  Without onnxruntime the
weights run on the port's own executor (``metrics/onnx_exec.py``).
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

SAMPLING_RATE = 16000
INPUT_LENGTH = 9.01

_POLY = {
    False: {  # standard DNSMOS
        "ovr": [-0.06766283, 1.11546468, 0.04602535],
        "sig": [-0.08397278, 1.22083953, 0.0052439],
        "bak": [-0.13166888, 1.60915514, -0.39604546],
    },
    True: {  # personalized
        "ovr": [-0.00533021, 0.005101, 1.18058466, -0.11236046],
        "sig": [-0.01019296, 0.02751166, 1.19576786, -0.24348726],
        "bak": [-0.04976499, 0.44276479, -0.1644611, 0.96883132],
    },
}


def _find_model(personalized: bool) -> Path:
    sub = "pDNSMOS" if personalized else "DNSMOS"
    candidates = []
    env = os.environ.get("OPEN_UNIVERSE_DNSMOS_DIR")
    if env:
        candidates.append(Path(env) / sub / "sig_bak_ovr.onnx")
        candidates.append(Path(env) / "sig_bak_ovr.onnx")
    here = Path(__file__).parent
    candidates.append(here / "dnsmos_models" / sub / "sig_bak_ovr.onnx")
    for c in candidates:
        if c.exists():
            return c
    raise FileNotFoundError(
        f"DNSMOS model sig_bak_ovr.onnx not found (looked in {candidates}); "
        "set OPEN_UNIVERSE_DNSMOS_DIR")


class Compute_DNSMOS:
    def __init__(self, personalized_MOS: bool = False,
                 sampling_rate: int = SAMPLING_RATE, num_threads=None,
                 session=None):
        """``session`` injects any object with onnxruntime's
        ``run(None, {"input_1": feats})`` interface — tests use a stub to
        exercise the windowing/calibration pipeline without onnxruntime."""
        if session is None:
            try:
                import onnxruntime as ort

                sess_opt = ort.SessionOptions()
                if num_threads is not None:
                    sess_opt.intra_op_num_threads = num_threads
                session = ort.InferenceSession(
                    str(_find_model(personalized_MOS)), sess_opt)
            except ImportError:
                # without onnxruntime: run the official weights with the
                # in-house executor
                from .onnx_exec import OnnxSession

                session = OnnxSession(str(_find_model(personalized_MOS)))
        self.onnx_sess = session
        self.is_personalized_MOS = personalized_MOS
        self.fs = sampling_rate

    def _polyfit(self, sig, bak, ovr):
        p = _POLY[self.is_personalized_MOS]
        return (np.polyval(p["sig"], sig), np.polyval(p["bak"], bak),
                np.polyval(p["ovr"], ovr))

    def __call__(self, audio: np.ndarray, fs: int) -> dict:
        audio = np.asarray(audio, np.float32).reshape(-1)
        if fs != self.fs:
            from ..data.audio import resample_audio

            audio = resample_audio(audio, fs, self.fs)
        actual_len = len(audio)
        len_samples = int(INPUT_LENGTH * self.fs)
        while len(audio) < len_samples:
            audio = np.append(audio, audio)

        num_hops = int(np.floor(len(audio) / self.fs) - INPUT_LENGTH) + 1
        hop = self.fs
        raw = {"sig": [], "bak": [], "ovr": []}
        cal = {"sig": [], "bak": [], "ovr": []}
        for idx in range(num_hops):
            seg = audio[int(idx * hop): int((idx + INPUT_LENGTH) * hop)]
            if len(seg) < len_samples:
                continue
            feats = seg.astype(np.float32)[None, :]
            mos_sig_r, mos_bak_r, mos_ovr_r = self.onnx_sess.run(
                None, {"input_1": feats})[0][0]
            mos_sig, mos_bak, mos_ovr = self._polyfit(mos_sig_r, mos_bak_r,
                                                      mos_ovr_r)
            raw["sig"].append(mos_sig_r)
            raw["bak"].append(mos_bak_r)
            raw["ovr"].append(mos_ovr_r)
            cal["sig"].append(mos_sig)
            cal["bak"].append(mos_bak)
            cal["ovr"].append(mos_ovr)

        return {
            "len_in_sec": actual_len / self.fs,
            "sr": self.fs,
            "num_hops": num_hops,
            "OVRL_raw": float(np.mean(raw["ovr"])),
            "SIG_raw": float(np.mean(raw["sig"])),
            "BAK_raw": float(np.mean(raw["bak"])),
            "OVRL": float(np.mean(cal["ovr"])),
            "SIG": float(np.mean(cal["sig"])),
            "BAK": float(np.mean(cal["bak"])),
        }
