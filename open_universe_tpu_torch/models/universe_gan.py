"""UNIVERSE++ (reference universe_gan.py): the adversarially trained
UNIVERSE.

For inference it is the ``Universe`` sampler plus the "signal decoupling"
layer: a snake-activated 3-tap conv that turns the conditioner's auxiliary
features (B, T, n_channels) into a waveform (B, T, 1), used by ``aux_to_wav``
(``enhance``'s ``warm_start`` and ``use_aux_signal``).  The reference never
optimises that layer, so a checkpoint's EMA shadow of it equals its raw
value; the loader reads both like any other parameter.  Not ported: the GAN
losses (MPD/MRD discriminators, mel L1, feature matching).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..nn.blocks import PReLUConv
from .universe import Universe


class UniverseGAN(Universe):
    def __init__(self, *args, use_signal_decoupling: bool = False,
                 signal_decoupling_act: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.use_signal_decoupling = use_signal_decoupling
        if use_signal_decoupling:
            self.signal_decoupling_layer = PReLUConv(
                self.n_channels, 1, 3, padding="same",
                act_type=signal_decoupling_act)
        else:
            self.signal_decoupling_layer = None

    def model_param_keys(self):
        keys = ("score_model", "condition_model")
        if self.use_signal_decoupling:
            keys += ("signal_decoupling_layer",)
        return keys

    def aux_to_wav(self, y_aux: torch.Tensor) -> torch.Tensor:
        if self.signal_decoupling_layer is not None:
            return self.signal_decoupling_layer(y_aux)
        return y_aux
