"""UNIVERSE++ (reference universe_gan.py): the adversarially trained
UNIVERSE.

In this slice the class is the ``Universe`` sampler under the name the
UNIVERSE++ preset returns.  Not ported yet: the snake-activated signal
decoupling layer and ``aux_to_wav``, and the GAN losses (MPD/MRD
discriminators, mel L1, feature matching).
"""
from __future__ import annotations

from .universe import Universe


class UniverseGAN(Universe):
    pass
