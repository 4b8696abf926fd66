"""The UNIVERSE(++) diffusion model: the sampler (JAX package
``models/universe.py``).

``Universe.enhance`` runs the conditioner once and the score network
``n_steps`` times (EDM fast path, or the generic score path), in inference
scope and without autograd, so eligible ConvBlocks take the fused kernel.
It takes every argument of the JAX package's ``enhance`` but ``packed``:
ensembles (mean, median, signal_median), warm start, ``use_aux_signal`` and
the fake-score probe (``target``).  Not ported yet: non-identity transforms
and the training losses.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import kernels
from ..utils.norm import normalize_batch
from ..utils.stats import signal_median
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
        """The sampler's ``count`` standard-normal draws of ``shape``, from
        ``generator`` or, when given, the arrays of ``noise``."""
        if noise is None:
            return [torch.randn(shape, generator=generator, device=device)
                    for _ in range(count)]
        draws = [torch.as_tensor(z, dtype=torch.float32, device=device)
                 for z in noise]
        if len(draws) != count or any(tuple(z.shape) != tuple(shape) for z in draws):
            raise ValueError(f"noise must be {count} draws of shape {tuple(shape)}, "
                             f"got {[tuple(z.shape) for z in draws]}")
        return draws

    @staticmethod
    def _as_batch(x: torch.Tensor) -> torch.Tensor:
        """(T,), (B, T) or (B, T, C) -> (B, T, C)."""
        if x.dim() == 1:
            return x[None, :, None]
        if x.dim() == 2:
            return x[:, :, None]
        if x.dim() > 3:
            raise ValueError("input should have at most 3 dimensions")
        return x

    @torch.no_grad()
    def enhance(self, mix, n_steps: Optional[int] = None,
                epsilon: Optional[float] = None,
                target: Optional[torch.Tensor] = None,
                fake_score_snr: Optional[float] = None,
                use_aux_signal: bool = False,
                keep_rms: bool = False,
                ensemble: Optional[int] = None,
                ensemble_stat: str = "median",
                warm_start: Optional[int] = None,
                compute_dtype: Optional[torch.dtype] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[Any]] = None) -> torch.Tensor:
        """Iterative score-based enhancement (reference universe.py:231-375).

        mix: (T,), (B, T) or (B, T, C) waveform, moved to the model's device.
        target: the clean signal, shaped like mix.  Given, the score network
        is replaced by the fake-score probe: the analytic score towards the
        target plus noise at ``fake_score_snr`` dB (default 5).
        use_aux_signal: return ``aux_to_wav`` of the conditioner's auxiliary
        signal; the sampler does not run.
        ensemble: enhance E copies of the batch with independent noise and
        reduce them with ``ensemble_stat``: mean, median (the mean of the
        two middle members of an even ensemble) or signal_median.
        warm_start: start the sampler at step k from ``aux_to_wav`` of the
        auxiliary signal plus noise at sigma[k]; n_steps - 1 - k steps run.
        compute_dtype: run the networks in this dtype (e.g. torch.bfloat16)
        while the sampler state, normalisation and the STFT stay float32.
        generator: draws the sampler noise (on the model's device).
        noise: the draws themselves, replacing the generator, each of shape
        (E*B, T_padded, C) (E = 1 without an ensemble, rows member-major):
        the initial draw, one per sampler step (n_steps - 1 - warm_start),
        then with ``target`` one per probe call (n_steps - warm_start).
        With ``use_aux_signal`` there are none.
        """
        with kernels.inference_scope():
            return self._enhance(
                mix, n_steps, epsilon, target, fake_score_snr, use_aux_signal,
                keep_rms, ensemble, ensemble_stat, warm_start, compute_dtype,
                generator, noise)

    def aux_to_wav(self, y_aux: torch.Tensor) -> torch.Tensor:
        return y_aux

    def _enhance(self, mix, n_steps, epsilon, target, fake_score_snr,
                 use_aux_signal, keep_rms, ensemble, ensemble_stat, warm_start,
                 compute_dtype, generator, noise):
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
        mix = self._as_batch(mix)

        mix_rms = torch.sqrt(torch.mean(mix**2, dim=(-2, -1), keepdim=True))
        if ensemble is not None:
            mix_shape = tuple(mix.shape)
            mix = mix.repeat(ensemble, 1, 1)  # member-major, as jnp.tile
            mix_rms = mix_rms.repeat(ensemble, 1, 1)
        mix_len = mix.shape[1]
        mix, pad = self.pad(mix)
        if target is not None:
            target = self._as_batch(torch.as_tensor(target, device=device).float())
            if ensemble is not None:
                target = target.repeat(ensemble, 1, 1)
            target, _ = self.pad(target, pad=pad)
        (mix, target), *_ = self.normalize_batch((mix, target))
        mix_wav = mix
        score_snr = 5.0 if fake_score_snr is None else fake_score_snr

        # sampler coefficients (reference universe.py:300-311)
        delta_t = 1.0 / (n_steps - 1)
        gamma = (self.diff_kwargs["sigma_max"] / self.diff_kwargs["sigma_min"]) ** (
            -delta_t)
        eta = 1.0 - gamma**epsilon
        beta = math.sqrt(1.0 - gamma ** (2.0 * (epsilon - 1.0)))

        time = torch.linspace(0.0, 1.0, n_steps, device=device).flip(0)
        sigma = self.get_std_dev(time).to(mix.dtype)
        bsz = mix.shape[0]

        cond, aux_signal, _ = self.condition_model(mix.to(net_dtype),
                                                   x_wav=mix_wav.to(net_dtype))
        aux_signal = aux_signal.float()

        if use_aux_signal:
            self._draws(noise, generator, mix.shape, 0, device)
            x = self.aux_to_wav(aux_signal.to(net_dtype)).float()
        else:
            n_start = 0 if warm_start is None else warm_start
            n_loop = n_steps - 1 - n_start
            n_probe = 0 if target is None else n_loop + 1
            sig = None if warm_start is None else self.aux_to_wav(aux_signal)
            draws = self._draws(noise, generator,
                                mix.shape if sig is None else sig.shape,
                                1 + n_loop + n_probe, device)
            steps, probes = draws[1:1 + n_loop], draws[1 + n_loop:]
            x = draws[0] * sigma[0] if sig is None else sig + draws[0] * sigma[n_start]

            if self.with_edm and target is None:
                # EDM fast path: with speech_est = w_skip*x + w_out*net_out
                # and score = (speech_est - x)/sigma^2, the step
                # x <- x + sigma^2*eta*score + beta*z is
                # x <- (1 - eta + eta*w_skip)*x + eta*w_out*net_out + beta*z
                w = self._edm_weights(sigma)
                noise_sig = w["noise"] * sigma
                for i in range(n_start, n_steps - 1):
                    net_out = self.score_model(
                        (w["in"][i] * x).to(net_dtype),
                        noise_sig[i].expand(bsz).to(net_dtype), cond)
                    cx = 1.0 - eta + eta * w["skip"][i]
                    cn = eta * w["out"][i]
                    x = (cx * x + cn * net_out.float()
                         + (beta * sigma[i + 1]) * steps[i - n_start])
                # final denoise: x + sigma^2*score == speech_est
                net_out = self.score_model((w["in"][-1] * x).to(net_dtype),
                                           noise_sig[-1].expand(bsz).to(net_dtype),
                                           cond)
                x = w["skip"][-1] * x + w["out"][-1] * net_out.float()
            else:
                def score_fn(x, s, probe):
                    s = s.expand(bsz)
                    if target is None:
                        return self.score(x.to(net_dtype), s.to(net_dtype),
                                          cond).float()
                    # the fake-score probe, against the target in the
                    # sampler's domain (JAX's fix of reference
                    # universe.py:276, which discards the transformed target)
                    true_score = -(x - target) / s[:, None, None] ** 2
                    score_rms = torch.sqrt(torch.mean(true_score**2))
                    return true_score + probe * (score_rms * 10.0 ** (-score_snr / 20.0))

                for i in range(n_start, n_steps - 1):
                    j = i - n_start
                    score = score_fn(x, sigma[i], probes[j] if probes else None)
                    z = steps[j] * sigma[i + 1]
                    x = x + sigma[i] ** 2 * eta * score + beta * z
                score = score_fn(x, sigma[-1], probes[-1] if probes else None)
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

        if ensemble is not None:
            x = ensemble_reduce(x.reshape((-1,) + mix_shape), ensemble_stat)

        if x_ndim == 1:
            return x[0, :, 0]
        if x_ndim == 2:
            return x[:, :, 0]
        return x


def ensemble_reduce(x: torch.Tensor, stat: str) -> torch.Tensor:
    """Reduce (E, B, T, C) ensemble members to (B, T, C)."""
    if stat == "mean":
        return torch.mean(x, dim=0)
    if stat == "median":
        # jnp.median: the mean of the two middle members of an even count
        # (torch.median returns the lower one)
        n = x.shape[0]
        s = torch.sort(x, dim=0).values
        if n % 2:
            return s[n // 2]
        return (s[n // 2 - 1] + s[n // 2]) * 0.5
    if stat == "signal_median":
        return signal_median(x)
    raise NotImplementedError(stat)
