"""LoRA fine-tuning of a trained UNIVERSE(++) (JAX package
``models/universe_lora.py``, reference networks/universe/lora.py).

``UniverseLoRA`` loads a checkpoint (``load_model``: EMA applied, weight norm
folded, on the CPU until the trainer moves it), keeps the networks, the
transform and, with ``use_hifigan_loss``, the MPD and MRD discriminators
(the other loss modules go), injects LoRA adapters into the score network
and the conditioner (``nn/lora.py``), and leaves ``requires_grad`` on the
adapters, the biases (``lora_train_biases``) and ``lora_train_names`` only.

It trains through the unrolled sampler (``forward``): the conditioner runs
once with gradients; of the ``n_steps - 1`` sampler steps the first
``n_steps - n_steps_backprop`` run under ``torch.no_grad()`` (JAX cuts them
with ``stop_gradient``, the same function), and the last loop steps and the
final score evaluation carry gradients.  The noise comes from a
``torch.Generator`` or is given (``noise``: the initial draw, then one per
loop step, in the order JAX's key chain splits them).  While adapters are
attached no ConvBlock takes the fused kernel, in any autograd state
(``ConvBlock._fused_eligible``); ``merge_lora`` folds them into a plain
``Universe``, whose ``enhance`` does.

The losses (``{name: {weight, kwargs}}``, e.g. ``MultiResL1SpecLoss``) and,
with ``use_hifigan_loss``, the frozen discriminators' generator and
feature-matching terms (weighted by ``weight_hifigan_loss``) make the
training objective; validation uses the same objective under ``val/``
names.  ``partial_diffusion_random_steps`` raises, as in the JAX package.
"""
from __future__ import annotations

import copy
import functools
import math
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union  # noqa: F401 (enhance's hints)

import torch
import torch.nn.functional as F

from ..nn import lora
from .discriminators import feature_loss, generator_loss
from ..utils.norm import as_batch, clip_protect, like_input, rms
from .enhancement import EnhancementBaseModel
from .universe import Universe


class UniverseLoRA(EnhancementBaseModel):
    def __init__(self, model: Union[str, Path, Universe], fs: int,
                 losses: Optional[dict] = None, training: Optional[dict] = None,
                 validation: Optional[dict] = None, optimizer: Optional[dict] = None,
                 scheduler: Optional[dict] = None, grad_clipper: Optional[dict] = None,
                 diffusion: Optional[dict] = None, n_steps_backprop: int = 1,
                 use_lora: bool = True, use_lora_score: bool = True,
                 use_lora_condition: bool = True, lora_rank: int = 16,
                 lora_alpha: Optional[float] = None, lora_train_biases: bool = True,
                 lora_train_names: Sequence[str] = (), use_hifigan_loss: bool = False,
                 use_partial_diffusion: bool = False,
                 partial_diffusion_random_steps: bool = False,
                 weight_hifigan_loss: float = 1.0):
        if n_steps_backprop < 1:
            raise ValueError("n_steps_backprop should be at least 1")
        if partial_diffusion_random_steps:
            # the reference redraws n_steps per call (lora.py:239-242); the
            # JAX package refuses it, and so does the port
            raise NotImplementedError(
                "partial_diffusion_random_steps is not supported; train with a fixed "
                "diffusion.n_steps (or alternate n_steps between runs)")
        if isinstance(model, (str, Path)):
            from ..inference.model_loader import load_model

            model = load_model(model, load_ema=True, fold_wn=True, device="cpu",
                               trainable=use_hifigan_loss)
        if fs != model.fs:
            raise ValueError("model fs must match the requested fs")
        super().__init__(fs, normalization_norm=model.normalization_norm, model=model,
                         losses=losses, training=training, validation=validation,
                         optimizer=optimizer, scheduler=scheduler, grad_clipper=grad_clipper,
                         normalization_kwargs=model.normalization_kwargs)
        self.n_steps_backprop = n_steps_backprop
        self.diff_kwargs = dict(diffusion or {"n_steps": 8, "epsilon": 1.3})
        self.use_hifigan_loss = use_hifigan_loss
        self.weight_hifigan_loss = weight_hifigan_loss
        self.use_partial_diffusion = use_partial_diffusion
        self.use_lora = use_lora
        self.use_lora_score = use_lora_score
        self.use_lora_condition = use_lora_condition
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.lora_train_biases = lora_train_biases
        self.lora_train_names = list(lora_train_names)
        self._fix_model()

    def _fix_model(self):
        """Drop the loss modules (keep MPD/MRD for the HiFi-GAN loss), inject
        the adapters (score network drawn from seed 0, conditioner from
        seed 1) and set what trains (reference lora.py:111-121, 141-158)."""
        m = self.model
        keep = {"loss_mpd", "loss_mrd"} if self.use_hifigan_loss else set()
        if self.use_hifigan_loss and getattr(m, "loss_mpd", None) is None:
            raise ValueError("use_hifigan_loss needs a UNIVERSE++ checkpoint with its "
                             "discriminators")
        for k in m.loss_param_keys():
            if k not in keep and getattr(m, k, None) is not None:
                setattr(m, k, None)
        if self.use_lora:
            if self.use_lora_score:
                lora.inject(m.score_model, self.lora_rank, self.lora_alpha,
                            torch.Generator().manual_seed(0))
            if self.use_lora_condition:
                lora.inject(m.condition_model, self.lora_rank, self.lora_alpha,
                            torch.Generator().manual_seed(1))
        # over the whole model, the kept MPD/MRD included: with
        # lora_train_biases their biases train too, leaf for leaf as JAX's
        # trainable_mask_lora over the whole ``model`` tree (intersected
        # with buffer_mask by its trainer; the port's buffers are no
        # parameters)
        self.trainable = lora.set_trainable(self, self.lora_train_biases,
                                            self.lora_train_names)

    def normalize_batch(self, batch, norm=None):
        return self.model.normalize_batch(batch, norm=norm)

    def merge_lora(self) -> Universe:
        """A plain Universe with the adapters folded into its weights (its
        discriminators left out), in eval mode: its ``enhance`` takes the
        fused kernel."""
        m = self.model
        skip = {id(getattr(m, k)): None for k in ("loss_mpd", "loss_mrd")
                if getattr(m, k, None) is not None}
        merged = copy.deepcopy(m, skip)
        lora.remove(merged)
        for mod in merged.modules():
            if isinstance(mod, torch.nn.RNNBase):
                mod.flatten_parameters()
        return merged.requires_grad_(True).eval()

    # ------------------------------------------------------------------ sampler
    def forward(self, mix: torch.Tensor, n_steps: Optional[int] = None,
                epsilon: Optional[float] = None, keep_rms: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[Any]] = None,
                rows: Optional[slice] = None) -> torch.Tensor:
        """The unrolled sampler with gradient gating (reference
        lora.py:300-397) on a (T,), (B, T) or (B, T, C) mix; the output has
        the mix's shape.  ``noise``: n_steps standard-normal draws shaped
        like the transformed padded mix (the initial one, then one per loop
        step), else drawn from ``generator``.  ``rows``: a data-parallel
        rank's rows (``parallel/mesh.py``): the draws are made for the whole
        batch, the output is these rows'."""
        if epsilon is None:
            epsilon = self.diff_kwargs.get("epsilon", 1.3)
        if n_steps is None:
            n_steps = self.diff_kwargs.get("n_steps", 8)
        ndim = mix.dim()
        mix = as_batch(mix)
        if self.use_partial_diffusion:
            x = self._partial_diffusion(mix, n_steps, epsilon, generator, noise, rows)
            return like_input(x, ndim)

        m = self.model
        grad_on = torch.is_grad_enabled()
        mix_rms, mix_len = rms(mix), mix.shape[1]
        mix_p, pad = m.pad(mix)
        (mix_n, _), *_ = m.normalize_batch((mix_p, None))
        mix_t = m.transform(mix_n)

        delta_t = 1.0 / (n_steps - 1)
        gamma = (m.diff_kwargs["sigma_max"] / m.diff_kwargs["sigma_min"]) ** (-delta_t)
        eta = 1.0 - gamma**epsilon
        beta = math.sqrt(1.0 - gamma ** (2.0 * (epsilon - 1.0)))
        time = torch.linspace(0.0, 1.0, n_steps, device=mix.device).flip(0)
        sigma = m.get_std_dev(time).to(mix_t.dtype)
        bsz = mix_t.shape[0]

        draws = m._draws(noise, generator, mix_t.shape, n_steps, mix.device)
        if rows is not None:
            mix_rms, mix_n, mix_t = mix_rms[rows], mix_n[rows], mix_t[rows]
            draws = [d[rows] for d in draws]
            bsz = mix_t.shape[0]
        cond, _, _ = m.condition_model(mix_t, x_wav=mix_n)
        x = draws[0] * sigma[0]
        for n in range(n_steps - 1):
            # gradients in the last n_steps_backprop score evaluations only
            with torch.set_grad_enabled(grad_on and n >= n_steps - self.n_steps_backprop):
                score = m.score(x, sigma[n].expand(bsz), cond)
                x = x + sigma[n] ** 2 * eta * score + beta * (draws[n + 1] * sigma[n + 1])
        score = m.score(x, sigma[-1].expand(bsz), cond)
        x = x + sigma[-1] ** 2 * score

        x = m.unpad(m.transform(x, inv=True), pad)
        if x.shape[1] < mix_len:
            x = F.pad(x, (0, 0, 0, mix_len - x.shape[1]))
        if keep_rms:
            x = x * mix_rms / torch.clamp(rms(x), min=1e-5)
        return like_input(clip_protect(x), ndim)

    def _partial_diffusion(self, mix, n_steps, epsilon, generator=None, noise=None,
                           rows=None):
        """Each sample starts at its own time t_final ~ U(0, 1) (reference
        lora.py:231-298); the mix is not padded and the result is the
        transform's inverse, as in the JAX package."""
        m = self.model
        grad_on = torch.is_grad_enabled()
        bsz = mix.shape[0]
        t_final = torch.rand(bsz, generator=generator, device=mix.device)
        delta_t = (1.0 - t_final) / (n_steps - 1)
        (mix_n, _), *_ = m.normalize_batch((mix, None))
        mix_t = m.transform(mix_n)
        ratio = m.diff_kwargs["sigma_max"] / m.diff_kwargs["sigma_min"]
        gamma = ratio ** (-delta_t)
        eta = 1.0 - gamma**epsilon
        beta = torch.sqrt(1.0 - gamma ** (2.0 * (epsilon - 1.0)))

        draws = m._draws(noise, generator, mix_t.shape, n_steps, mix.device)
        if rows is not None:
            mix_n, mix_t, delta_t, eta, beta = (
                t[rows] for t in (mix_n, mix_t, delta_t, eta, beta))
            draws = [d[rows] for d in draws]
            bsz = mix_t.shape[0]
        time = torch.ones(bsz, device=mix.device)
        sigma = m.get_std_dev(time)
        cond, _, _ = m.condition_model(mix_t, x_wav=mix_n)
        x = draws[0] * sigma[:, None, None]
        for n in range(n_steps - 1):
            with torch.set_grad_enabled(grad_on and n >= n_steps - self.n_steps_backprop):
                score = m.score(x, sigma, cond)
                time = time - delta_t
                sigma_next = m.get_std_dev(time)
                x = (x + (sigma**2 * eta)[:, None, None] * score
                     + beta[:, None, None] * (draws[n + 1] * sigma_next[:, None, None]))
                sigma = sigma_next
        score = m.score(x, sigma, cond)
        x = x + (sigma**2)[:, None, None] * score
        return m.transform(x, inv=True)

    # ------------------------------------------------------------------ losses
    def hifi_gan_loss(self, y_est: torch.Tensor, target: torch.Tensor):
        """The frozen discriminators' generator and feature-matching losses
        on (B, T, 1) signals: (gen MPD, gen MRD, fm MPD, fm MRD)."""
        m = self.model
        _, y_df_g, f_f_r, f_f_g = m.loss_mpd(target, y_est)
        _, y_ds_g, f_s_r, f_s_g = m.loss_mrd(target, y_est)
        return (generator_loss(y_df_g)[0], generator_loss(y_ds_g)[0],
                feature_loss(f_f_r, f_f_g), feature_loss(f_s_r, f_s_g))

    def compute_losses(self, enh: torch.Tensor, target: torch.Tensor):
        loss, losses = super().compute_losses(enh, target)
        if self.use_hifigan_loss:
            gf, gs, ff, fs_ = self.hifi_gan_loss(as_batch(enh), as_batch(target))
            loss = loss + self.weight_hifigan_loss * (gf + gs + ff + fs_)
            losses.update({"mpd": gf, "mrd": gs, "mpd_fm": ff, "mrd_fm": fs_})
        return loss, losses

    def training_losses(self, mix: torch.Tensor, target: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        draws: Optional[Dict[str, Any]] = None,
                        rows: Optional[slice] = None):
        """(loss, metrics) of a raw (B, T, 1) batch: normalise, the sampler
        on mix[:, :, 0] with ``diffusion.n_steps`` (``draws["noise"]`` its
        draws, else ``generator``), the losses against target[:, :, 0].
        ``rows`` as ``forward`` takes it."""
        (mix, target), *_ = self.normalize_batch((mix, target))
        enh = self.forward(mix[:, :, 0], n_steps=self.diff_kwargs.get("n_steps", 8),
                           generator=generator, noise=(draws or {}).get("noise"), rows=rows)
        if rows is not None:
            target = target[rows]
        loss, losses = self.compute_losses(enh, target[:, :, 0])
        return loss, {"train/main_loss": loss, **{f"train/{k}": v for k, v in losses.items()}}

    def validation_losses(self, mix: torch.Tensor, target: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[Dict[str, Any]] = None):
        """The training objective on a val batch, under ``val/`` names (the
        reference inherits EnhancementBaseModel.validation_step)."""
        loss, metrics = self.training_losses(mix, target, generator, draws)
        return loss, {"val/" + k[len("train/"):]: v for k, v in metrics.items()}

    @functools.wraps(Universe.enhance)
    def enhance(self, mix, **kwargs):
        # the inner model's enhance with the adapters attached (unfused);
        # its signature gives the enhance CLI its flags
        return self.model.enhance(mix, **kwargs)
