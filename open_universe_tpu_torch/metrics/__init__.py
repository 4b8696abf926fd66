"""Speech-quality metrics (reference metrics/ package; the port's copy of the
JAX package's ``metrics/``, without jax).

In-house implementations: LSD/si-LSD (torch), SI-SDR and CI-SDR, STOI/ESTOI,
PESQ (P.862, numpy), loudness.  Optional-dependency wrappers: DNSMOS and
PLCMOS (onnxruntime or the in-house ONNX executor, and the model files),
WER (an optional whisper normaliser), LPS (the port's wav2vec2 CTC model and
a local espeak checkpoint).
"""
from .bss import sdr, si_sdr  # noqa: F401
from .eval import EvalMetrics  # noqa: F401
from .lsd import log_spectral_distance  # noqa: F401
from .stoi import stoi  # noqa: F401
from .wrapper import Metrics  # noqa: F401


def __getattr__(name):
    # heavy/optional imports resolved lazily
    if name == "PESQ":
        from .pesq import PESQ

        return PESQ
    if name == "Compute_DNSMOS":
        from .dnsmos import Compute_DNSMOS

        return Compute_DNSMOS
    if name == "PLCMOSEstimator":
        from .plcmos import PLCMOSEstimator

        return PLCMOSEstimator
    if name == "LevenshteinPhonemeSimilarity":
        from .lps import LevenshteinPhonemeSimilarity

        return LevenshteinPhonemeSimilarity
    if name == "wer":
        from .wer import wer

        return wer
    raise AttributeError(name)
