"""The training steps (JAX package ``train/steps.py``).

``TrainStep`` is the single-optimizer step (``make_train_step``) of the
plain UNIVERSE and of the enhancement family (``UniverseLoRA``): the loss of
the model's ``training_losses`` (the plain UNIVERSE's score loss plus its two
MDN losses; the fine-tuning losses through LoRA's unrolled sampler), its
gradients for every parameter that requires one (all of the plain
UNIVERSE's, its MDN loss modules' included; LoRA's adapters and biases),
clipped as one group by ``grad_clipper``'s clipper, one AdamW update, then
EMA of ``model_param_keys()``.  The clipper's norm runs over those
gradients, as the reference's clipper does; the JAX package's step clips by
the norm of every parameter's gradient, the frozen ones' too (ROADMAP
queue 3).

``GANTrainStep`` is the UNIVERSE++ GAN step (``make_gan_train_step``), in
the reference's order:

1. one generator forward, its autograd graph kept;
2. the discriminators' LSGAN loss on the detached ``y_est``, their
   gradients, clipped per sub-tree (mpd, then mrd), and their update
   (held back while ``step < disc_freeze_step``);
3. the generator's losses against the just-updated discriminators, whose
   parameters take no gradient, backpropagated through the kept graph; the
   auxiliary loss, if the model has one, weighted by
   ``losses.aux_loss_schedule``'s warm-up (``aux_weight``; logged as
   ``train/aux_weight``);
4. the generator's gradients clipped per sub-tree (the score network, then
   the conditioner with the signal-decoupling layer), its update, then EMA.

The ``disc_frozen`` variant, for the steps before ``disc_freeze_step``,
leaves the discriminators out entirely.

With ``training.nan_guard`` a step whose loss or gradient norms are not
finite is rolled back: parameters, optimizer states, EMA (and AutoClip's
history) stay as they were, the step count moves on, and
``train/update_skipped`` is 1.  Only then does a step wait for the device.

The gradients of the last step stay in each parameter's ``.grad`` (after
clipping) until the next step begins.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional

import torch

from ..models.universe import Universe
from ..models.universe_gan import UniverseGAN
from .ema import EMA
from .optim import AutoClipper, clip_by_norm_, global_norm, set_lr


def _params(model, keys):
    return [p for k in keys for p in getattr(model, k).parameters()]


def aux_weight(model, step: int) -> float:
    """The auxiliary loss's weight at ``step`` (JAX ``make_gan_train_step``):
    a linear ramp from ``start_step`` over ``warmup_steps``, or a switch at
    ``start_step`` without a warm-up."""
    sched = model.losses_kwargs.get("aux_loss_schedule") or {}
    start, warmup = sched.get("start_step", 0), sched.get("warmup_steps", 0)
    if warmup > 0:
        return min(max((step - start) / warmup, 0.0), 1.0)
    return 1.0 if step >= start else 0.0


class TrainStep:
    """Applies steps to ``model`` (a plain UNIVERSE built with its losses,
    or a model of the enhancement family) in place.  ``opt`` updates the
    parameters that require a gradient; ``lr`` maps its count of applied
    updates to its learning rate; ``clipper`` (``optim.make_clipper``)
    clips the gradients as one group.  ``step`` and ``updates`` count steps
    and applied updates."""

    def __init__(self, model: Universe, opt: torch.optim.Optimizer,
                 lr: Callable[[int], float], ema: Optional[EMA] = None,
                 clipper=None):
        self.model = model
        self.opt, self.lr = opt, lr
        self.ema = ema
        self.clipper = clipper
        self.nan_guard = bool(model.train_kwargs.get("nan_guard", False))
        self.step = self.updates = 0

    def __call__(self, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, Any]] = None,
                 adaptive: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` ({"noisy", "clean"}: (B, T, 1) on the
        model's device).  ``draws`` and ``adaptive`` as
        ``GANTrainStep.__call__`` takes them.  Returns the step's metrics as
        tensors."""
        model = self.model
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        # only the diffusion models sample time adaptively
        adaptive = ({"pr_cum": (adaptive or {}).get("pr_cum"),
                     "bins": (adaptive or {}).get("bins")}
                    if isinstance(model, Universe) else {})
        loss, metrics = model.training_losses(batch["noisy"], batch["clean"], generator,
                                              draws, **adaptive)
        loss.backward()
        # a parameter the loss does not reach has a zero gradient, as in
        # jax.grad: AdamW then still decays it
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        # nothing is updated before the check but AutoClip's history
        saved = (copy.deepcopy(self.clipper.__dict__)
                 if self.nan_guard and isinstance(self.clipper, AutoClipper) else None)
        if self.clipper is not None:
            gnorm, clip = self.clipper(grads)
            metrics["grad/norm"] = gnorm
            metrics["grad/clipped_norm"] = torch.minimum(gnorm, clip.to(gnorm.device))
        else:
            metrics["grad/norm"] = global_norm(grads)
        ok = True
        if self.nan_guard:
            ok = bool(torch.isfinite(torch.stack([loss.detach(), metrics["grad/norm"]])).all())
            metrics["train/update_skipped"] = torch.tensor(0.0 if ok else 1.0)
        if ok:
            set_lr(self.opt, self.lr(self.updates))
            self.opt.step()
            self.updates += 1
            if self.ema is not None:
                self.ema.update()
        elif saved is not None:
            self.clipper.__dict__.update(saved)
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}


class GANTrainStep:
    """Applies GAN steps to ``model`` in place.

    opt_gen updates the parameters of ``model.optimized_param_keys()``,
    opt_disc those of ``model.disc_param_keys()``; lr_gen / lr_disc map each
    optimizer's count of applied updates to its learning rate.  ``step``,
    ``gen_updates`` and ``disc_updates`` count steps and applied updates.
    """

    def __init__(self, model: UniverseGAN, opt_gen: torch.optim.Optimizer,
                 opt_disc: torch.optim.Optimizer, lr_gen: Callable[[int], float],
                 lr_disc: Callable[[int], float], ema: Optional[EMA] = None,
                 grad_clip_vals: Optional[dict] = None):
        self.model = model
        self.opt_gen, self.opt_disc = opt_gen, opt_disc
        self.lr_gen, self.lr_disc = lr_gen, lr_disc
        self.ema = ema
        self.clip_vals = grad_clip_vals or {}
        self.nan_guard = bool(model.train_kwargs.get("nan_guard", False))
        self.step = self.gen_updates = self.disc_updates = 0

    def __call__(self, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Dict[str, Any]] = None,
                 disc_frozen: bool = False,
                 adaptive: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` ({"noisy", "clean"}: (B, T, 1) on the
        model's device).  The random draws come from ``generator`` unless
        ``draws`` gives them: "u" (B,) uniform draws for sigma, "dice" (B,)
        the adaptive time sampling's bin draws, "z" the score's noise
        (B, T, 1), "perm" the dynamic-mixing permutation.  ``adaptive``
        ({"pr_cum", "bins"}, the trainer's validation histogram) feeds
        ``training.time_sampling: adaptive``.  Returns the step's metrics as
        tensors."""
        model = self.model
        draws = draws or {}
        mpd, mrd = _params(model, ["loss_mpd"]), _params(model, ["loss_mrd"])
        score_p = _params(model, ["score_model"])
        cond_p = _params(model, [k for k in model.model_param_keys() if k != "score_model"])
        for p in mpd + mrd + score_p + cond_p:
            p.grad = None

        mix, target = batch["noisy"], batch["clean"]
        target_original = batch.get("clean_original", target)
        if model.train_kwargs.get("dynamic_mixing", False):
            perm = draws.get("perm")
            if perm is None:
                perm = torch.randperm(mix.shape[0], generator=generator,
                                      device=mix.device)
            mix = target + (mix - target)[torch.as_tensor(perm, device=mix.device)]
        (mix, target, target_original), *_ = model.normalize_batch(
            (mix, target, target_original))

        adaptive = adaptive or {}
        gen_out = model.generator_forward(mix, target, target_original, generator,
                                          u=draws.get("u"), z=draws.get("z"),
                                          pr_cum=adaptive.get("pr_cum"),
                                          bins=adaptive.get("bins"),
                                          dice=draws.get("dice"))

        zero = torch.zeros((), device=mix.device)
        disc_applied, saved = False, None
        if disc_frozen:
            l_disc, d_metrics, gnorm_mpd, gnorm_mrd = zero, {}, zero, zero
            adv_on = False
        else:
            l_disc, d_metrics = model.discriminator_losses(gen_out["y_est"].detach(),
                                                           target_original)
            l_disc.backward()
            gnorm_mpd = clip_by_norm_([p.grad for p in mpd], self.clip_vals.get("mpd", 1000.0))
            gnorm_mrd = clip_by_norm_([p.grad for p in mrd], self.clip_vals.get("mrd", 1000.0))
            freeze = model.disc_freeze_step
            adv_on = disc_applied = self.step >= freeze if freeze > 0 else True
            if disc_applied:
                if self.nan_guard:
                    saved = ([p.detach().clone() for p in mpd + mrd],
                             copy.deepcopy(self.opt_disc.state_dict()))
                set_lr(self.opt_disc, self.lr_disc(self.disc_updates))
                self.opt_disc.step()

        for p in mpd + mrd:
            p.requires_grad_(False)
        try:
            l_gen, g_metrics = model.generator_losses(
                gen_out, target_original, adv_on, adversarial=not disc_frozen,
                aux_loss_weight=aux_weight(model, self.step))
        finally:
            for p in mpd + mrd:
                p.requires_grad_(True)
        l_gen.backward()
        gnorm_score = clip_by_norm_([p.grad for p in score_p], self.clip_vals.get("score", 1000.0))
        gnorm_cond = clip_by_norm_([p.grad for p in cond_p], self.clip_vals.get("cond", 1000.0))

        metrics = {**d_metrics, **g_metrics, "grad/score": gnorm_score,
                   "grad/cond": gnorm_cond, "grad/mpd": gnorm_mpd, "grad/mrd": gnorm_mrd}
        if model.loss_aux is not None:
            metrics["train/aux_weight"] = torch.tensor(aux_weight(model, self.step))
        ok = True
        if self.nan_guard:
            ok = bool(torch.isfinite(torch.stack(
                [l_disc, l_gen, gnorm_score, gnorm_cond, gnorm_mpd, gnorm_mrd])).all())
            metrics["train/update_skipped"] = torch.tensor(0.0 if ok else 1.0)
        if ok:
            self.disc_updates += int(disc_applied)
            set_lr(self.opt_gen, self.lr_gen(self.gen_updates))
            self.opt_gen.step()
            self.gen_updates += 1
            if self.ema is not None:
                self.ema.update()
        elif saved is not None:
            with torch.no_grad():
                for p, old in zip(mpd + mrd, saved[0]):
                    p.copy_(old)
            self.opt_disc.load_state_dict(saved[1])
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}
