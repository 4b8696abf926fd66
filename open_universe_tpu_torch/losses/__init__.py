"""Training losses (JAX package ``losses/``): the multi-resolution L1
time + STFT-magnitude loss, the weighted loss combiner, and the phoneme
losses (``PhonemeLoss``, ``PhonemeCTCLoss``, ``PhonemeEmbeddingLoss`` and
their ``PhonemePredictor``, on the port's frozen wav2vec2 CTC model),
imported lazily.
"""
from .combine import MultiLoss  # noqa: F401
from .multires_stft import MultiResL1SpecLoss  # noqa: F401


def __getattr__(name):
    if name in ("PhonemeLoss", "PhonemeCTCLoss", "PhonemeEmbeddingLoss",
                "PhonemePredictor"):
        from . import phoneme_loss

        return getattr(phoneme_loss, name)
    raise AttributeError(name)
