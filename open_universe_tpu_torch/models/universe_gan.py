"""UNIVERSE++ (reference universe_gan.py): the adversarially trained
UNIVERSE.

In this slice the class is the ``Universe`` sampler under the name the
UNIVERSE++ preset returns.  Not ported yet: the snake-activated signal
decoupling layer and ``aux_to_wav``, and the GAN losses (MPD/MRD
discriminators, mel L1, feature matching).  ``use_signal_decoupling`` only
records whether a checkpoint's EMA shadow lists that layer's parameters.
"""
from __future__ import annotations

from .universe import Universe


class UniverseGAN(Universe):
    def __init__(self, *args, use_signal_decoupling: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.use_signal_decoupling = use_signal_decoupling

    def model_param_keys(self):
        keys = ("score_model", "condition_model")
        if self.use_signal_decoupling:
            keys += ("signal_decoupling_layer",)
        return keys
