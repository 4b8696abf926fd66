"""UNIVERSE++ (reference universe_gan.py): the adversarially trained
UNIVERSE (JAX package ``models/universe_gan.py``).

For inference it is the ``Universe`` sampler plus the "signal decoupling"
layer: a snake-activated 3-tap conv that turns the conditioner's auxiliary
features (B, T, n_channels) into a waveform (B, T, 1), used by ``aux_to_wav``
(``enhance``'s ``warm_start`` and ``use_aux_signal``).

Built with its ``losses`` node (``configs/registry.py::instantiate_trainable``)
it also holds the MPD and MRD discriminators (``loss_mpd``, ``loss_mrd``)
and computes the three parts of a GAN step (``train/steps.py``):

  generator_forward     one forward of the conditioner and score networks
  discriminator_losses  LSGAN loss on (target, y_est), y_est detached by the caller
  generator_losses      score MSE + 45 * mel L1 + the auxiliary loss + the
                        adversarial and feature-matching terms, gated by
                        ``adversarial_on``

The auxiliary loss (``losses.aux_loss``, e.g. a ``MultiResL1SpecLoss``,
built by the registry into ``aux_loss_module``) compares ``y_est`` with the
target, scaled by the step's warm-up weight (``GANTrainStep``, from
``losses.aux_loss_schedule``) and by ``losses.weights.aux``.

Reference quirk kept: the signal-decoupling layer is applied and
EMA-shadowed but never optimised (``optimized_param_keys``), so a
checkpoint's EMA shadow of it equals its raw value.

With ``training.compute_dtype: bf16`` the generator networks and the
signal-decoupling layer run on bfloat16 casts of their parameters
(``Universe`` says how), and so do the discriminators, for their own loss
and for the adversarial terms; every output (the generator's, the
discriminators' logits and feature maps) is upcast before the losses,
which are float32.  The clean target of the mel and the adversarial losses
stays float32 until the discriminators cast it.  ``training.remat``
recomputes the conditioner's and the score's forwards in the backward.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..nn.blocks import PReLUConv
from .discriminators import (
    MultiPeriodDiscriminator,
    MultiResolutionDiscriminator,
    discriminator_loss,
    feature_loss,
    generator_loss,
)
from ..utils.params import at_least_f32
from .universe import Universe, cast_call, maybe_remat


def _f32(tree):
    """``at_least_f32`` over nested lists of tensors."""
    if isinstance(tree, (list, tuple)):
        return [_f32(t) for t in tree]
    return at_least_f32(tree)


class UniverseGAN(Universe):
    loss_aux = None  # the auxiliary loss, a callable on (y_est, target)

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

    def init_losses(self):
        """The discriminators, in place of the plain UNIVERSE's MDN losses
        (called by ``Universe.__init__`` when the model is built with its
        ``losses`` node)."""
        lk = self.losses_kwargs
        self.loss_aux = lk.get("aux_loss_module")
        self.loss_mpd = MultiPeriodDiscriminator(lk.get("multi_period_discriminator", {}))
        self.loss_mrd = MultiResolutionDiscriminator(
            lk.get("multi_resolution_discriminator", {}))
        self.disc_freeze_step = lk.get("disc_freeze_step", 0)

    def model_param_keys(self):
        keys = ("score_model", "condition_model")
        if self.use_signal_decoupling:
            keys += ("signal_decoupling_layer",)
        return keys

    def optimized_param_keys(self):
        """The generator sub-modules the optimizer updates: the reference's
        ``configure_optimizers`` leaves out the signal-decoupling layer."""
        return ("score_model", "condition_model")

    def disc_param_keys(self):
        return ("loss_mpd", "loss_mrd")

    def loss_param_keys(self):
        return self.disc_param_keys()

    def aux_to_wav(self, y_aux: torch.Tensor, dtype: Optional[torch.dtype] = None
                   ) -> torch.Tensor:
        if self.signal_decoupling_layer is not None:
            return cast_call(self.signal_decoupling_layer, dtype, y_aux)
        return y_aux

    def _discriminate(self, name: str, target_original, y_est):
        """(real scores, generated scores, real feature maps, generated
        feature maps) of discriminator ``name``, in ``training.compute_dtype``
        (parameters and both signals cast), upcast."""
        dt = self._train_dtype()
        if dt is not None:
            target_original, y_est = target_original.to(dt), y_est.to(dt)
        return _f32(cast_call(getattr(self, name), dt, target_original, y_est))

    # --------------------------------------------------------------- GAN parts
    def generator_forward(self, mix, target, target_original,
                          generator: Optional[torch.Generator] = None,
                          u: Optional[torch.Tensor] = None,
                          z: Optional[torch.Tensor] = None,
                          pr_cum=None, bins=None,
                          dice: Optional[torch.Tensor] = None,
                          rows: Optional[slice] = None) -> Dict[str, Any]:
        """One forward of the generator networks on normalised (B, T, 1)
        inputs, with autograd's graph kept for the generator's backward.
        sigma comes from uniform draws ``u`` (and, in ``adaptive`` time
        sampling with validation's histogram ``pr_cum``/``bins``, the bin
        draws ``dice``) and the score's noise is ``z`` (shaped like the
        transformed target): all drawn from ``generator`` unless given.
        ``rows``: a data-parallel rank's rows of the batch
        (``parallel/mesh.py``): the draws are the whole batch's, the outputs
        these rows'.  The outputs are float32 (or wider)."""
        sigma, time = self.sample_sigma(mix.shape[0], self.train_kwargs["time_sampling"],
                                        generator=generator, u=u, device=mix.device,
                                        pr_cum=pr_cum, bins=bins, dice=dice)
        dt = self._train_dtype()
        if dt is not None:
            mix, target = mix.to(dt), target.to(dt)
        mix_t, target_t = self.transform(mix), self.transform(target)
        if z is None:
            z = torch.randn(target_t.shape, generator=generator, device=mix.device)
        z = torch.as_tensor(z, dtype=target_t.dtype, device=mix.device)
        if rows is not None:
            mix_t, target_t, target_original, sigma, time, z = (
                t[rows] for t in (mix_t, target_t, target_original, sigma, time, z))
        # sigma follows the networks' dtype through x_t and the score network
        sigma_c = sigma.to(target_t.dtype)
        x_t = target_t + sigma_c[:, None, None] * z
        remat = bool(self.train_kwargs.get("remat", False))

        # the JAX package's conditioner takes the transformed mix as its
        # waveform input too
        cond, y_est, _ = self._cond_train(mix_t, mix_t, dt, remat)
        if self.detach_cond:
            cond = [c.detach() for c in cond]
        score = maybe_remat(remat, self.score, x_t, sigma_c, cond, dtype=dt)
        y_est = self.transform(self.aux_to_wav(y_est, dt), inv=True)
        mel = self.condition_model.input_mel.compute_mel_spec
        return {"y_est": at_least_f32(y_est), "score": at_least_f32(score),
                "sigma": sigma, "z": at_least_f32(z),
                "mel_y_est": at_least_f32(mel(y_est)),
                "mel_target": at_least_f32(mel(target_original)), "time": time}

    def discriminator_losses(self, y_est, target_original):
        """LSGAN loss of both discriminators; the caller detaches y_est."""
        y_df_r, y_df_g, _, _ = self._discriminate("loss_mpd", target_original, y_est)
        loss_f, _, _ = discriminator_loss(y_df_r, y_df_g)
        y_ds_r, y_ds_g, _, _ = self._discriminate("loss_mrd", target_original, y_est)
        loss_s, _, _ = discriminator_loss(y_ds_r, y_ds_g)
        loss = loss_f + loss_s
        return loss, {"train/loss_disc": loss, "train/loss_mpd": loss_f,
                      "train/loss_mrd": loss_s}

    def generator_losses(self, gen_out: Dict[str, Any], target_original,
                         adversarial_on: bool, adversarial: bool = True,
                         aux_loss_weight: Optional[float] = None):
        """Score MSE + weighted mel L1 + the auxiliary loss (scaled by
        ``aux_loss_weight``, the schedule's warm-up weight in [0, 1]) + the
        adversarial and feature terms.  ``adversarial`` False leaves the
        discriminators out entirely (the disc-frozen step);
        ``adversarial_on`` False computes the terms but leaves them out of
        the loss."""
        w = self.losses_kwargs.get("weights", {})
        sigma = gen_out["sigma"]
        l_score = torch.mean(torch.square(sigma[:, None, None] * gen_out["score"]
                                          + gen_out["z"]))
        loss_mel = torch.mean(torch.abs(gen_out["mel_y_est"] - gen_out["mel_target"]))
        zero = torch.zeros((), device=l_score.device)
        if self.loss_aux is not None and aux_loss_weight is not None:
            loss_aux = aux_loss_weight * self.loss_aux(gen_out["y_est"], target_original)
        else:
            loss_aux = zero
        if adversarial:
            y_est = gen_out["y_est"]
            y_df_r, y_df_g, fmap_f_r, fmap_f_g = self._discriminate(
                "loss_mpd", target_original, y_est)
            loss_fm_f = feature_loss(fmap_f_r, fmap_f_g)
            loss_gen_f, _ = generator_loss(y_df_g)
            y_ds_r, y_ds_g, fmap_s_r, fmap_s_g = self._discriminate(
                "loss_mrd", target_original, y_est)
            loss_fm_s = feature_loss(fmap_s_r, fmap_s_g)
            loss_gen_s, _ = generator_loss(y_ds_g)
        else:
            loss_fm_f = loss_gen_f = loss_fm_s = loss_gen_s = zero
        loss = (l_score * w.get("score", 1.0) + loss_mel * w.get("mel_l1", 45.0)
                + loss_aux * w.get("aux", 1.0))
        if adversarial_on:
            loss = loss + (loss_gen_s + loss_gen_f + loss_fm_s + loss_fm_f)
        metrics = {
            "train/loss_gen": loss, "train/score": l_score,
            "train/signal_mel": loss_mel, "train/signal_aux": loss_aux,
            "train/mrd_fm": loss_fm_s, "train/mpd_fm": loss_fm_f,
            "train/mrd_gen": loss_gen_s, "train/mpd_gen": loss_gen_f,
            "train/time_mean": torch.mean(gen_out["time"]),
        }
        return loss, metrics
