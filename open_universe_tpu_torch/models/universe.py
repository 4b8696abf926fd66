"""The UNIVERSE(++) diffusion model: the sampler (JAX package
``models/universe.py``).

``Universe.enhance`` runs the conditioner once and the score network
``n_steps`` times (EDM fast path, or the generic score path), in inference
scope and without autograd, so eligible ConvBlocks take the fused kernel.
Not ported yet: ensembles, warm start, ``use_aux_signal``, the fake-score
probe (``target``), non-identity transforms and the training losses.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import kernels
from ..utils.norm import normalize_batch
from .condition import ConditionerNetwork
from .score import ScoreNetwork


def _cfg(d: Optional[Dict[str, Any]], **defaults) -> Dict[str, Any]:
    out = dict(defaults)
    if d:
        out.update(d)
    return out


class IdentityTransform(nn.Module):
    """The identity waveform transform (reference layers/dyn_range_comp.py),
    the only one ported."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Universe(nn.Module):
    """UNIVERSE score-based speech enhancement model."""

    def __init__(self, fs: int = 16000, normalization_norm=2,
                 score_model: Optional[ScoreNetwork] = None,
                 condition_model: Optional[ConditionerNetwork] = None,
                 diffusion: Optional[dict] = None,
                 normalization_kwargs: Optional[dict] = None,
                 edm: Optional[dict] = None,
                 transform: Optional[nn.Module] = None):
        super().__init__()
        if transform is not None and not isinstance(transform, IdentityTransform):
            raise NotImplementedError(
                f"{type(transform).__name__} is not ported; only the identity "
                "transform is")
        self.fs = fs
        self.normalization_norm = normalization_norm
        self.normalization_kwargs = _cfg(normalization_kwargs)
        self.diff_kwargs = _cfg(diffusion, schedule="geometric", sigma_min=5e-4,
                                sigma_max=5.0, n_steps=8, epsilon=1.3)
        self.score_model = score_model if score_model is not None else ScoreNetwork()
        self.condition_model = (condition_model if condition_model is not None
                                else ConditionerNetwork())
        self.with_edm = edm is not None
        self.edm_kwargs = _cfg(edm) if edm else {}
        self.n_channels = self.score_model.n_channels
        self.tot_ds = math.prod(self.score_model.rate_factors)

    def model_param_keys(self):
        """Sub-modules whose parameters a checkpoint's EMA shadow covers, in
        the order it lists them."""
        return ("score_model", "condition_model")

    # ------------------------------------------------------------- primitives
    def normalize_batch(self, batch, norm=None):
        if norm is None:
            norm = self.normalization_norm
        return normalize_batch(batch, norm=norm, **self.normalization_kwargs)

    def pad(self, x: torch.Tensor, pad: Optional[int] = None):
        """Centre-pad the time axis to a multiple of the total downsampling;
        an input that is already a multiple still gets a full period."""
        if pad is None:
            pad = self.tot_ds - x.shape[1] % self.tot_ds
        return F.pad(x, (0, 0, pad // 2, pad - pad // 2)), pad

    def unpad(self, x: torch.Tensor, pad: int) -> torch.Tensor:
        return x[:, pad // 2: x.shape[1] - (pad - pad // 2)]

    def get_std_dev(self, time: torch.Tensor) -> torch.Tensor:
        if self.diff_kwargs["schedule"] == "geometric":
            s_min = self.diff_kwargs["sigma_min"]
            s_max = self.diff_kwargs["sigma_max"]
            return s_min * torch.pow(s_max / s_min, time)
        raise NotImplementedError(self.diff_kwargs["schedule"])

    def _edm_weights(self, sigma: torch.Tensor) -> Dict[str, Any]:
        level_db = self.edm_kwargs.get(
            "data_level_db", self.normalization_kwargs.get("level_db", 0.0))
        sigma_data = 10.0 ** (level_db / 20.0)
        sigma_norm = torch.sqrt(sigma**2 + sigma_data**2)
        return {
            "skip": sigma_data**2 / (sigma**2 + sigma_data**2),
            "in": 1.0 / sigma_norm,
            "out": sigma * sigma_data / sigma_norm,
            "noise": self.edm_kwargs["noise"],
        }

    def score(self, x: torch.Tensor, sigma: torch.Tensor, cond) -> torch.Tensor:
        """Score function; applies the EDM wrapper when configured."""
        if not self.with_edm:
            return self.score_model(x, sigma, cond)
        w = self._edm_weights(sigma)
        net_out = self.score_model(w["in"][:, None, None] * x,
                                   w["noise"] * sigma, cond)
        speech_est = w["skip"][:, None, None] * x + w["out"][:, None, None] * net_out
        return (speech_est - x) / (sigma[:, None, None] ** 2)

    # ---------------------------------------------------------------- sampler
    def _draws(self, noise, generator, shape, count, device):
        """The sampler's standard-normal draws: the initial one, then one per
        loop step.  ``noise`` (``count`` arrays of ``shape``) replaces the
        generator."""
        if noise is None:
            return [torch.randn(shape, generator=generator, device=device)
                    for _ in range(count)]
        draws = [torch.as_tensor(z, dtype=torch.float32, device=device)
                 for z in noise]
        if len(draws) != count or any(tuple(z.shape) != tuple(shape) for z in draws):
            raise ValueError(f"noise must be {count} draws of shape {tuple(shape)}, "
                             f"got {[tuple(z.shape) for z in draws]}")
        return draws

    @torch.no_grad()
    def enhance(self, mix, n_steps: Optional[int] = None,
                epsilon: Optional[float] = None, keep_rms: bool = False,
                compute_dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[Any]] = None) -> torch.Tensor:
        """Iterative score-based enhancement (reference universe.py:231-375).

        mix: (T,), (B, T) or (B, T, C) waveform, moved to the model's device.
        compute_dtype: run the networks in this dtype (e.g. torch.bfloat16)
        while the sampler state, normalisation and the STFT stay float32.
        generator: draws the sampler noise (on the model's device).
        noise: the draws themselves, replacing the generator: n_steps arrays
        of shape (B, T_padded, C), the initial draw first.
        """
        with kernels.inference_scope():
            return self._enhance(mix, n_steps, epsilon, keep_rms, compute_dtype,
                                 generator, noise)

    def _enhance(self, mix, n_steps, epsilon, keep_rms, compute_dtype,
                 generator, noise):
        device = next(self.parameters()).device
        net_dtype = compute_dtype or torch.float32
        if epsilon is None:
            epsilon = self.diff_kwargs["epsilon"]
        if n_steps is None:
            n_steps = self.diff_kwargs["n_steps"]

        mix = torch.as_tensor(mix, device=device)
        if not mix.is_floating_point():
            mix = mix.float()
        x_ndim = mix.dim()
        if x_ndim == 1:
            mix = mix[None, :, None]
        elif x_ndim == 2:
            mix = mix[:, :, None]
        elif x_ndim > 3:
            raise ValueError("input should have at most 3 dimensions")

        mix_rms = torch.sqrt(torch.mean(mix**2, dim=(-2, -1), keepdim=True))
        mix_len = mix.shape[1]
        mix, pad = self.pad(mix)
        (mix, _), *_ = self.normalize_batch((mix, None))
        mix_wav = mix

        # sampler coefficients (reference universe.py:300-311)
        delta_t = 1.0 / (n_steps - 1)
        gamma = (self.diff_kwargs["sigma_max"] / self.diff_kwargs["sigma_min"]) ** (
            -delta_t)
        eta = 1.0 - gamma**epsilon
        beta = math.sqrt(1.0 - gamma ** (2.0 * (epsilon - 1.0)))

        time = torch.linspace(0.0, 1.0, n_steps, device=device).flip(0)
        sigma = self.get_std_dev(time).to(mix.dtype)
        bsz = mix.shape[0]

        cond, _, _ = self.condition_model(mix.to(net_dtype),
                                          x_wav=mix_wav.to(net_dtype))

        n_loop = n_steps - 1
        draws = self._draws(noise, generator, mix.shape, n_loop + 1, device)
        x = draws[0] * sigma[0]

        if self.with_edm:
            # EDM fast path: with speech_est = w_skip*x + w_out*net_out and
            # score = (speech_est - x)/sigma^2, the step
            # x <- x + sigma^2*eta*score + beta*z is
            # x <- (1 - eta + eta*w_skip)*x + eta*w_out*net_out + beta*z
            w = self._edm_weights(sigma)
            noise_sig = w["noise"] * sigma
            for i in range(n_loop):
                net_out = self.score_model(
                    (w["in"][i] * x).to(net_dtype),
                    noise_sig[i].expand(bsz).to(net_dtype), cond)
                cx = 1.0 - eta + eta * w["skip"][i]
                cn = eta * w["out"][i]
                x = cx * x + cn * net_out.float() + (beta * sigma[i + 1]) * draws[i + 1]
            # final denoise: x + sigma^2*score == speech_est
            net_out = self.score_model((w["in"][-1] * x).to(net_dtype),
                                       noise_sig[-1].expand(bsz).to(net_dtype),
                                       cond)
            x = w["skip"][-1] * x + w["out"][-1] * net_out.float()
        else:
            for i in range(n_loop):
                s_now = sigma[i]
                score = self.score(x.to(net_dtype), s_now.expand(bsz).to(net_dtype),
                                   cond).float()
                z = draws[i + 1] * sigma[i + 1]
                x = x + s_now**2 * eta * score + beta * z
            score = self.score(x.to(net_dtype),
                               sigma[-1].expand(bsz).to(net_dtype), cond).float()
            x = x + sigma[-1] ** 2 * score

        x = self.unpad(x, pad)
        if x.shape[1] < mix_len:
            x = F.pad(x, (0, 0, 0, mix_len - x.shape[1]))
        if keep_rms:
            x_rms = torch.sqrt(torch.mean(x**2, dim=(-2, -1), keepdim=True))
            x = x * mix_rms / torch.clamp(x_rms, min=1e-5)
        # clip protection
        scale = torch.amax(torch.abs(x), dim=1, keepdim=True)
        x = torch.where(scale > 1.0, x / scale, x)

        if x_ndim == 1:
            return x[0, :, 0]
        if x_ndim == 2:
            return x[:, :, 0]
        return x
