"""Training losses (JAX package ``losses/``): the multi-resolution L1
time + STFT-magnitude loss and the weighted loss combiner.

The phoneme losses (``PhonemeLoss``, ``PhonemeCTCLoss``,
``PhonemeEmbeddingLoss``, ``PhonemePredictor``) need the pretrained wav2vec2
weights, which are not in the repo: their names raise
``NotImplementedError``, and the registry does not know their targets
(drop them from a config with ``model.losses.<name>=null``).
"""
from .combine import MultiLoss  # noqa: F401
from .multires_stft import MultiResL1SpecLoss  # noqa: F401

PHONEME_NAMES = ("PhonemeLoss", "PhonemeCTCLoss", "PhonemeEmbeddingLoss",
                 "PhonemePredictor")


def __getattr__(name):
    if name in PHONEME_NAMES:
        raise NotImplementedError(
            f"{name} is not ported: it needs the pretrained wav2vec2 weights, "
            "which are not in the repo (disable it with model.losses.<name>=null)")
    raise AttributeError(name)
