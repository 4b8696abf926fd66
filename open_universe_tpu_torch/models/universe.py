"""The UNIVERSE(++) diffusion model: the sampler, the time sampling and the
losses of training (JAX package ``models/universe.py``).

``Universe.enhance`` runs the conditioner once and the score network
``n_steps`` times (EDM fast path, or the generic score path), in inference
scope and without autograd, so eligible ConvBlocks take the fused kernel.
It takes every argument of the JAX package's ``enhance`` but ``packed``:
ensembles (mean, median, signal_median), warm start, ``use_aux_signal`` and
the fake-score probe (``target``).  A ``transform`` (``models/transforms.py``)
maps the normalised waveforms into the networks' domain and the sampler's
result back.  ``sample_sigma`` draws training's (sigma, time) in all six
modes, ``adaptive`` from validation's histogram of score losses by time bin.
``compute_losses(train=False)`` is validation's score loss in one time bin;
``compute_losses(train=True)`` adds the plain UNIVERSE's two mixture-density
losses (``models/mdn.py``): the conditioner's auxiliary signal against the
target, its latent against the target's mel spectrogram, each skipped when
not finite (``finite_or_skip``).  ``training_losses`` is the score-only
training step's objective (``train/steps.py::TrainStep``).

Mixed precision (``training.compute_dtype: bf16``) is the JAX package's
policy, not ``torch.autocast``'s: the networks of ``model_param_keys()``
run with their parameters cast to bfloat16 (``cast_call``, JAX's
``_cast_tree``; the casts are differentiable, so the gradients, the
optimizer and EMA stay on the float32 parameters), ``mix`` and ``target``
are cast, sigma follows the networks' dtype into ``x_t`` and the score
network, and the losses are computed in float32 from upcast outputs
(``utils/params.py::at_least_f32``).  The MDN loss modules keep float32
parameters, but their layers cast them to their bf16 inputs, on both sides.
The score noise is drawn in float32 and cast to bfloat16 (JAX draws it in
bfloat16; given draws are cast the same way).  ``training.remat`` recomputes
the conditioner's and the score's forwards in the backward
(``torch.utils.checkpoint``, non-reentrant), where JAX wraps the same two
calls in ``jax.checkpoint``: the results are the same, memory and time
change.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import kernels
from ..parallel import mesh
from ..utils import spans
from ..utils.norm import as_batch, clip_protect, like_input, normalize_batch, rms
from ..utils.params import at_least_f32
from ..utils.random import center_truncated_normal
from ..utils.stats import signal_median
from .condition import ConditionerNetwork
from .mdn import MixtureDensityNetworkLoss
from .score import ScoreNetwork
from .transforms import IdentityTransform


def _cfg(d: Optional[Dict[str, Any]], **defaults) -> Dict[str, Any]:
    out = dict(defaults)
    if d:
        out.update(d)
    return out


def finite_or_skip(loss_fn, est: torch.Tensor, across_ranks: bool = False):
    """The reference's skip of a non-finite loss (universe.py:526-539)
    without a host sync: ``bad`` stays on the device.  A plain ``where`` on
    the loss would still send NaN back (its zero gradient times the NaN
    partials of the bad forward), so the loss is recomputed at zeroed
    estimates where it is not finite, whose partials are finite, and gated
    out of the total.  ``across_ranks``: a data-parallel step's shard, which
    skips where any rank's loss is not finite (JAX's loss is the global
    batch's).  Returns (the term for the total, the raw value for the
    metrics)."""
    with torch.no_grad():
        raw = loss_fn(est.detach())
    bad = ~torch.isfinite(raw)
    if across_ranks:
        bad = mesh.any_rank(bad)
    safe = loss_fn(torch.where(bad, torch.zeros_like(est), est))
    return torch.where(bad, torch.zeros_like(safe), safe), raw


def cast_call(module: nn.Module, dtype: Optional[torch.dtype], *args, **kwargs):
    """``module(*args, **kwargs)`` with its floating parameters cast to
    ``dtype`` (JAX ``Universe._cast_tree``); None calls it as it is."""
    if dtype is None:
        return module(*args, **kwargs)
    cast = {n: p.to(dtype) for n, p in module.named_parameters() if p.is_floating_point()}
    return torch.func.functional_call(module, cast, args, kwargs)


def maybe_remat(remat: bool, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, recomputed in the backward with ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


class Universe(nn.Module):
    """UNIVERSE score-based speech enhancement model."""

    def __init__(self, fs: int = 16000, normalization_norm=2,
                 score_model: Optional[ScoreNetwork] = None,
                 condition_model: Optional[ConditionerNetwork] = None,
                 diffusion: Optional[dict] = None,
                 normalization_kwargs: Optional[dict] = None,
                 edm: Optional[dict] = None,
                 transform: Optional[nn.Module] = None,
                 losses: Optional[dict] = None,
                 training: Optional[dict] = None,
                 validation: Optional[dict] = None,
                 optimizer: Optional[dict] = None,
                 scheduler: Optional[dict] = None,
                 grad_clipper: Optional[dict] = None,
                 with_noise_target: bool = False,
                 detach_cond: bool = False):
        """The training nodes (losses .. grad_clipper) of a config are kept
        as dicts for the trainer; a model built for inference has none, and
        so no loss modules (``init_losses``)."""
        super().__init__()
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
        self.latent_n_channels = 2 ** len(self.score_model.rate_factors) * self.n_channels
        self.transform = transform if transform is not None else IdentityTransform()
        self.with_noise_target = with_noise_target
        self.detach_cond = detach_cond
        self.losses_kwargs = _cfg(losses, weights={"score": 1.0, "signal": 1.0,
                                                   "latent": 1.0},
                                  mdn_n_comp=3, mdn_alpha_per_sample=True)
        self.train_kwargs = _cfg(training, audio_len=2.0, time_sampling="time_uniform",
                                 dynamic_mixing=False, ema_decay=0.999)
        self.val_kwargs = _cfg(validation)
        self.opt_kwargs = optimizer
        self.schedule_kwargs = scheduler
        self.grad_clip_kwargs = grad_clipper
        self.loss_signal = self.loss_latent = None
        self.built_for_training = losses is not None
        if self.built_for_training:
            self.init_losses()

    def _train_dtype(self) -> Optional[torch.dtype]:
        """The networks' dtype in training (``training.compute_dtype``):
        bfloat16 for bf16, else None (float32)."""
        if self.train_kwargs.get("compute_dtype") in ("bf16", "bfloat16"):
            return torch.bfloat16
        return None

    def init_losses(self):
        """The two mixture-density losses of the weights that are > 0: the
        signal's on the conditioner's auxiliary output against the target
        (and the noise, with ``with_noise_target``), the latent's on its
        bottleneck against the target's mel spectrogram."""
        lk = self.losses_kwargs
        weights = lk.get("weights", {})
        cond_in = self.condition_model.input_channels
        num_targets = 2 if self.with_noise_target else 1
        audio_len = self.train_kwargs["audio_len"]
        if weights.get("signal", 0.0) > 0.0:
            self.loss_signal = MixtureDensityNetworkLoss(
                est_channels=self.n_channels, tgt_channels=cond_in * num_targets,
                n_comp=lk.get("mdn_n_comp", 3), sampling_rate=self.fs // cond_in,
                sample_len_s=audio_len,
                alpha_per_sample=lk.get("mdn_alpha_per_sample", False))
        if weights.get("latent", 0.0) > 0.0:
            self.loss_latent = MixtureDensityNetworkLoss(
                est_channels=self.latent_n_channels,
                tgt_channels=self.condition_model.n_mels * num_targets,
                n_comp=lk.get("mdn_n_comp", 3),
                sampling_rate=self.fs // (cond_in * self.tot_ds), sample_len_s=audio_len,
                alpha_per_sample=lk.get("mdn_alpha_per_sample", False))

    def loss_param_keys(self):
        """Sub-modules that only training's losses use (an evaluation copy
        leaves them out)."""
        return tuple(k for k in ("loss_signal", "loss_latent")
                     if getattr(self, k) is not None)

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

    def score(self, x: torch.Tensor, sigma: torch.Tensor, cond,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Score function; applies the EDM wrapper when configured.  The
        score network's parameters are cast to ``dtype`` (``cast_call``)."""
        if not self.with_edm:
            return cast_call(self.score_model, dtype, x, sigma, cond)
        w = self._edm_weights(sigma)
        net_out = cast_call(self.score_model, dtype, w["in"][:, None, None] * x,
                            w["noise"] * sigma, cond)
        speech_est = w["skip"][:, None, None] * x + w["out"][:, None, None] * net_out
        return (speech_est - x) / (sigma[:, None, None] ** 2)

    # ----------------------------------------------------------- time sampling
    def sample_sigma(self, batch_size: int, time_sampling: str = "time_uniform",
                     t_min: float = 0.0, t_max: float = 1.0,
                     generator: Optional[torch.Generator] = None,
                     u: Optional[torch.Tensor] = None, device=None,
                     pr_cum: Optional[torch.Tensor] = None,
                     bins: Optional[torch.Tensor] = None,
                     dice: Optional[torch.Tensor] = None):
        """(sigma, time), each (batch_size,) float32, in one of the six
        reference modes (JAX ``Universe.sample_sigma``).  Every mode maps one
        uniform draw per row, ``u`` in [0, 1), drawn from ``generator`` or
        given (JAX's ``uniform(key, (B,))`` gives JAX's values).

        ``adaptive`` with the validation histogram (``pr_cum``, the
        cumulative share of the score loss by time bin, and the bins' edges
        ``bins``) picks a bin per row by a second uniform draw, ``dice``,
        and takes ``u`` as the position inside it (JAX's ``_adaptive_time``
        draws dice from the first half of the key's split and the position
        from the second); without the histogram it is uniform time."""
        if u is None:
            u = torch.rand(batch_size, generator=generator, device=device)
        u = torch.as_tensor(u, dtype=torch.float32, device=device)
        s_min = self.diff_kwargs["sigma_min"]
        s_max = self.diff_kwargs["sigma_max"]
        time = (t_max - t_min) * u + t_min
        if time_sampling == "time_uniform":
            pass
        elif time_sampling == "adaptive":
            time = u if pr_cum is None or bins is None else self._adaptive_time(
                u, pr_cum, bins, generator, dice)
        elif time_sampling == "sigma_linear":
            return (s_max - s_min) * time + s_min, time
        elif time_sampling == "diffsym":
            sigma = s_max + s_min - ((s_max - s_min) * time + s_min)
            num = torch.log10((s_max + s_min - sigma) / s_min)
            time = 1.0 - num / math.log10(s_max / s_min)
        elif time_sampling == "time_discrete":
            steps = torch.linspace(0.0, 1.0, self.diff_kwargs.get("n_steps", 32),
                                   device=time.device)
            time = steps[torch.argmin(torch.abs(steps[:, None] - time[None, :]), dim=0)]
        elif time_sampling.startswith("time_normal"):
            try:
                alpha = float(time_sampling.split("_")[2])
            except (IndexError, ValueError):
                alpha = 0.95
            time = center_truncated_normal(u, area=alpha, minval=t_min, maxval=t_max)
        else:
            raise NotImplementedError(time_sampling)
        return self.get_std_dev(time), time

    @staticmethod
    def _adaptive_time(u, pr_cum, bins, generator=None, dice=None):
        """Bin-weighted uniform time from the validation histogram."""
        pr_cum = torch.as_tensor(pr_cum, dtype=torch.float32, device=u.device)
        bins = torch.as_tensor(bins, dtype=torch.float32, device=u.device)
        if dice is None:
            dice = torch.rand(u.shape, generator=generator, device=u.device)
        dice = torch.as_tensor(dice, dtype=torch.float32, device=u.device)
        n_bins = bins.shape[0] - 1
        # invert the cumulative distribution to pick a bin per sample
        idx = torch.clamp(torch.searchsorted(pr_cum, dice, right=True) - 1,
                          0, n_bins - 1)
        lo, hi = bins[idx], bins[idx + 1]
        return lo + (hi - lo) * u

    def compute_losses(self, mix: torch.Tensor, target: torch.Tensor,
                       train: bool = True, time_sampling: str = "time_uniform",
                       t_min: float = 0.0, t_max: float = 1.0,
                       generator: Optional[torch.Generator] = None,
                       u: Optional[torch.Tensor] = None,
                       z: Optional[torch.Tensor] = None,
                       pr_cum: Optional[torch.Tensor] = None,
                       bins: Optional[torch.Tensor] = None,
                       dice: Optional[torch.Tensor] = None,
                       rows: Optional[slice] = None):
        """The losses on amplitude-normalised (B, T, C) inputs (JAX
        ``Universe.compute_losses``), sigma drawn with ``time_sampling`` in
        [t_min, t_max].  The draws (sigma's uniform ``u``, adaptive's bin
        draws ``dice``, the noise ``z`` shaped like the transformed target)
        come from ``generator`` unless given.  ``rows``: a data-parallel
        rank's rows (``parallel/mesh.py``); the draws are made for the whole
        batch, and the losses are those of these rows.

        train=False: the score loss mean((sigma score(x_t) + z)^2), the loss
        validation bins by time.  train=True: (loss, score loss, signal MDN
        loss, latent MDN loss, time), the loss their sum by
        ``losses.weights``, each MDN term skipped where it is not finite (its
        raw value is returned).  With ``with_noise_target`` the MDN targets
        hold the noise (mix - target) beside the target.  The networks run
        in ``training.compute_dtype`` (in both modes, as in JAX) and, with
        ``training.remat`` and train=True, are recomputed in the
        backward."""
        dt = self._train_dtype()
        if dt is not None:
            mix, target = mix.to(dt), target.to(dt)
        mix_trans, tgt_trans = self.transform(mix), self.transform(target)
        sigma, time = self.sample_sigma(mix.shape[0], time_sampling, t_min, t_max,
                                        generator=generator, u=u, device=mix.device,
                                        pr_cum=pr_cum, bins=bins, dice=dice)
        if z is None:
            z = torch.randn(tgt_trans.shape, generator=generator, device=tgt_trans.device)
        z = torch.as_tensor(z, dtype=tgt_trans.dtype, device=tgt_trans.device)
        if rows is not None:
            mix, target, mix_trans, tgt_trans, sigma, time, z = (
                t[rows] for t in (mix, target, mix_trans, tgt_trans, sigma, time, z))
        # sigma follows the networks' dtype, or x_t (and the score network
        # with it) would promote back to float32
        sigma_c = sigma.to(tgt_trans.dtype)
        x_t = tgt_trans + sigma_c[:, None, None] * z
        remat = train and bool(self.train_kwargs.get("remat", False))
        cond, y_est, h_est = self._cond_train(mix_trans, mix, dt, remat)
        if self.detach_cond:
            cond = [c.detach() for c in cond]
        score = maybe_remat(remat, self.score, x_t, sigma_c, cond, dtype=dt)
        l_score = torch.mean(torch.square(sigma[:, None, None] * at_least_f32(score)
                                          + at_least_f32(z)))
        if not train:
            return l_score

        if self.with_noise_target:
            noise = mix - target
            target_aux = torch.cat((target, noise), dim=-1)
            target_aux_trans = torch.cat((tgt_trans, self.transform(noise)), dim=-1)
        else:
            target_aux, target_aux_trans = target, tgt_trans
        weights = self.losses_kwargs["weights"]
        l_latent_term = l_latent = l_signal_term = l_signal = l_score.new_zeros(())
        if weights.get("latent", 0.0) > 0.0 and h_est is not None:
            mel_target = self._mel_target(target_aux)
            l_latent_term, l_latent = finite_or_skip(
                lambda e: self._loss_module("latent")(e, mel_target), h_est,
                across_ranks=rows is not None)
        if weights.get("signal", 0.0) > 0.0:
            l_signal_term, l_signal = finite_or_skip(
                lambda e: self._loss_module("signal")(e, target_aux_trans), y_est,
                across_ranks=rows is not None)
        loss = (weights.get("score", 1.0) * l_score
                + weights.get("signal", 0.0) * l_signal_term
                + weights.get("latent", 0.0) * l_latent_term)
        return loss, l_score, l_signal, l_latent, time

    def _loss_module(self, name: str) -> MixtureDensityNetworkLoss:
        module = getattr(self, "loss_" + name)
        if module is None:
            raise RuntimeError(f"the model was built without its {name} loss "
                               "(configs/registry.py::instantiate_trainable)")
        return module

    def _mel_target(self, target_aux: torch.Tensor) -> torch.Tensor:
        """The latent loss's target: the target's mel spectrogram over its
        own norm (floored at 1e-5)."""
        mel = self.condition_model.input_mel.compute_mel_spec(target_aux)
        norm = torch.sqrt(torch.sum(mel**2, dim=(-2, -1), keepdim=True))
        return mel / torch.clamp(norm, min=1e-5)

    def training_losses(self, mix: torch.Tensor, target: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[Dict[str, Any]] = None,
                        pr_cum: Optional[torch.Tensor] = None,
                        bins: Optional[torch.Tensor] = None,
                        rows: Optional[slice] = None):
        """The score-only step's objective on a raw (B, T, C) batch (JAX
        ``Universe.training_losses``): ``dynamic_mixing`` (the noise of the
        batch permuted), normalisation, ``compute_losses(train=True)`` in
        ``training.time_sampling`` (``adaptive`` with validation's
        histogram ``pr_cum``/``bins``).  ``draws`` gives the random draws:
        "perm" the permutation, "u", "dice" and "z" as compute_losses takes
        them; the rest come from ``generator``.  ``rows`` as compute_losses
        takes it: the batch and the draws are the whole batch's.  Returns
        (loss, metrics)."""
        draws = draws or {}
        if self.train_kwargs.get("dynamic_mixing", False):
            perm = draws.get("perm")
            if perm is None:
                perm = torch.randperm(mix.shape[0], generator=generator, device=mix.device)
            mix = target + (mix - target)[torch.as_tensor(perm, device=mix.device)]
        (mix, target), *_ = self.normalize_batch((mix, target))
        loss, l_score, l_signal, l_latent, t = self.compute_losses(
            mix, target, train=True, time_sampling=self.train_kwargs["time_sampling"],
            generator=generator, u=draws.get("u"), z=draws.get("z"),
            pr_cum=pr_cum, bins=bins, dice=draws.get("dice"), rows=rows)
        metrics = {"train/loss": loss, "train/score": l_score, "train/signal": l_signal,
                   "train/latent": l_latent, "train/time_mean": torch.mean(t.float())}
        return loss, metrics

    def _cond_train(self, mix_trans: torch.Tensor, mix_wav: torch.Tensor,
                    dtype: Optional[torch.dtype] = None, remat: bool = False):
        """The conditioner's training forward: (conditions, y_hat, h), its
        parameters cast to ``dtype``, recomputed in the backward with
        ``remat``."""
        return maybe_remat(remat, cast_call, self.condition_model, dtype, mix_trans,
                           x_wav=mix_wav)

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
        (E*B, T_padded, C) (E = 1 without an ensemble, rows member-major;
        with a transform, the shape of the transformed padded mix):
        the initial draw, one per sampler step (n_steps - 1 - warm_start),
        then with ``target`` one per probe call (n_steps - warm_start).
        With ``use_aux_signal`` there are none.

        While a profiler records, the call is the span ``enhance`` (rows
        and length of ``mix``, n_steps), the conditioner's pass
        ``enhance.condition`` and each score pass ``enhance.score`` (its
        step): ``utils/spans.py``.
        """
        shape = np.shape(mix)
        with kernels.inference_scope(), spans.span(
                "enhance", rows=shape[0] if len(shape) > 1 else 1,
                T=shape[1] if len(shape) > 1 else shape[0],
                n_steps=n_steps or self.diff_kwargs["n_steps"]):
            return self._enhance(
                mix, n_steps, epsilon, target, fake_score_snr, use_aux_signal,
                keep_rms, ensemble, ensemble_stat, warm_start, compute_dtype,
                generator, noise)

    def aux_to_wav(self, y_aux: torch.Tensor, dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
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
        mix = as_batch(mix)

        mix_rms = rms(mix)
        if ensemble is not None:
            mix_shape = tuple(mix.shape)
            mix = mix.repeat(ensemble, 1, 1)  # member-major, as jnp.tile
            mix_rms = mix_rms.repeat(ensemble, 1, 1)
        mix_len = mix.shape[1]
        mix, pad = self.pad(mix)
        if target is not None:
            target = as_batch(torch.as_tensor(target, device=device).float())
            if ensemble is not None:
                target = target.repeat(ensemble, 1, 1)
            target, _ = self.pad(target, pad=pad)
        (mix, target), *_ = self.normalize_batch((mix, target))
        mix_wav = mix
        # the sampler runs in the transform's domain (the identity by default)
        mix = self.transform(mix)
        if target is not None:
            target = self.transform(target)
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

        with spans.span("enhance.condition"):
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
                    with spans.span("enhance.score", step=i):
                        net_out = self.score_model(
                            (w["in"][i] * x).to(net_dtype),
                            noise_sig[i].expand(bsz).to(net_dtype), cond)
                    cx = 1.0 - eta + eta * w["skip"][i]
                    cn = eta * w["out"][i]
                    x = (cx * x + cn * net_out.float()
                         + (beta * sigma[i + 1]) * steps[i - n_start])
                # final denoise: x + sigma^2*score == speech_est
                with spans.span("enhance.score", step=n_steps - 1):
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
                    # the fake-score probe, against the TRANSFORMED target:
                    # x lives in the transform's domain (JAX's fix of
                    # reference universe.py:276, which transforms the
                    # target but discards the result, so with a transform
                    # its probe mixes domains)
                    true_score = -(x - target) / s[:, None, None] ** 2
                    score_rms = torch.sqrt(torch.mean(true_score**2))
                    return true_score + probe * (score_rms * 10.0 ** (-score_snr / 20.0))

                for i in range(n_start, n_steps - 1):
                    j = i - n_start
                    with spans.span("enhance.score", step=i):
                        score = score_fn(x, sigma[i], probes[j] if probes else None)
                    z = steps[j] * sigma[i + 1]
                    x = x + sigma[i] ** 2 * eta * score + beta * z
                with spans.span("enhance.score", step=n_steps - 1):
                    score = score_fn(x, sigma[-1], probes[-1] if probes else None)
                x = x + sigma[-1] ** 2 * score

        x = self.unpad(self.transform(x, inv=True), pad)
        if x.shape[1] < mix_len:
            x = F.pad(x, (0, 0, 0, mix_len - x.shape[1]))
        if keep_rms:
            x = x * mix_rms / torch.clamp(rms(x), min=1e-5)
        x = clip_protect(x)

        if ensemble is not None:
            x = ensemble_reduce(x.reshape((-1,) + mix_shape), ensemble_stat)
        return like_input(x, x_ndim)


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
