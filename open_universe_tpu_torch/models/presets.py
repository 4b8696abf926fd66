"""Model presets mirroring the reference experiment configurations (JAX
package ``models/presets.py``; identity transform only).

Each preset builds its model on the CPU, draws its weights from ``seed``
(``nn/layers.py::init_weights``) and moves it to ``device``: CUDA unless the
caller names another.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..nn.layers import init_weights
from ..utils.device import resolve_device
from .condition import ConditionerNetwork
from .score import ScoreNetwork
from .universe import Universe
from .universe_gan import UniverseGAN

Device = Optional[Union[str, torch.device]]


def universepp(fs: int = 16000, device: Device = None, seed: int = 0) -> UniverseGAN:
    """UNIVERSE++ at 16 kHz (reference config/model/default.yaml) or 24 kHz
    (config/model/universepp_24k.yaml)."""
    device = resolve_device(device)
    if fs == 16000:
        rate_factors, n_channels, n_mels = [2, 4, 4, 5], 32, 80
    elif fs == 24000:
        rate_factors, n_channels, n_mels = [2, 3, 5, 8], 48, 128
    else:
        raise ValueError(f"UNIVERSE++ has presets at 16000 and 24000 Hz, not fs={fs}")
    score = ScoreNetwork(
        fb_kernel_size=3, rate_factors=rate_factors, n_channels=n_channels,
        n_rff=32, noise_cond_dim=512, extra_conv_block=True,
        use_weight_norm=True, use_antialiasing=True, time_embedding="simple")
    cond = ConditionerNetwork(
        fb_kernel_size=3, rate_factors=rate_factors, n_channels=n_channels,
        n_mels=n_mels, n_mel_oversample=4, encoder_gru_residual=True,
        extra_conv_block=True, use_weight_norm=True, use_antialiasing=False)
    model = UniverseGAN(
        fs=fs, normalization_norm=2,
        normalization_kwargs={"ref": "both", "level_db": -26.0},
        score_model=score, condition_model=cond,
        diffusion={"schedule": "geometric", "sigma_min": 0.0005,
                   "sigma_max": 5.0, "n_steps": 8, "epsilon": 1.3},
        edm={"noise": 0.25}, use_signal_decoupling=True,
        signal_decoupling_act="snake")
    return init_weights(model, seed).to(device)


def universe_original(fs: int = 16000, device: Device = None,
                      seed: int = 0) -> Universe:
    """Plain UNIVERSE (reference config/model/universe_original.yaml)."""
    device = resolve_device(device)
    score = ScoreNetwork(
        fb_kernel_size=3, rate_factors=[2, 4, 4, 5], n_channels=32, n_rff=32,
        noise_cond_dim=512, extra_conv_block=True, use_weight_norm=False,
        use_antialiasing=False)
    cond = ConditionerNetwork(
        fb_kernel_size=3, rate_factors=[2, 4, 4, 5], n_channels=32, n_mels=80,
        n_mel_oversample=4, encoder_gru_residual=True, extra_conv_block=True,
        use_weight_norm=False, use_antialiasing=False)
    model = Universe(
        fs=fs, normalization_norm=2,
        normalization_kwargs={"ref": "both", "level_db": -26.0},
        score_model=score, condition_model=cond,
        diffusion={"schedule": "geometric", "sigma_min": 5e-4, "sigma_max": 5.0,
                   "n_steps": 8, "epsilon": 1.3})
    return init_weights(model, seed).to(device)
