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
finite is rolled back: parameters, optimizer states, the gradient
accumulators, EMA (and AutoClip's history) stay as they were, the step
count moves on, and ``train/update_skipped`` is 1.  Only then does a step
wait for the device.

Gradient accumulation (``optimizer.accumulate_grad_batches`` = k) follows
``optax.MultiSteps`` as the JAX trainer wraps each optimizer in it, not
Lightning: every call's gradients are clipped, then folded into a running
mean (``GradAccumulator``), and every k-th call applies the mean; the
learning rate counts applied updates, the step count (and with it
``disc_freeze_step`` and the aux loss's warm-up) counts calls, and EMA
moves on every call.  The discriminators' optimizer accumulates on its
own, from the first step it is not frozen.

Data parallelism (``parallel/mesh.py``): the batch and the draws are the
global batch's, each rank computes its dp group's rows, and every gradient
is averaged over the ranks before it is clipped; the metrics (and
``nan_guard``'s check) are the ranks' means.  Under tensor parallelism
(``parallel/tp.py``) a sharded parameter's gradient, moments and
accumulator are shards: the gradient is averaged over the dp group and
enters the clip norms whole.

The gradients of the last step stay in each parameter's ``.grad`` (after
clipping, or the accumulated mean where an update was applied) until the
next step begins.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional

import torch

from ..models.universe import Universe
from ..models.universe_gan import UniverseGAN
from ..parallel import mesh, tp
from .ema import EMA
from .optim import AutoClipper, clip_by_norm_, global_norm, set_lr


def _params(model, keys):
    return [p for k in keys for p in getattr(model, k).parameters()]


class GradAccumulator:
    """``optax.MultiSteps(every_k_schedule=k)`` for one optimizer's
    parameters: the running mean of k calls' gradients (optax's Welford
    update, acc + (g - acc) / (n + 1)), handed to the parameters' ``.grad``
    on the k-th."""

    def __init__(self, params, k: int = 1):
        self.params = list(params)
        self.k = max(int(k or 1), 1)
        self.mini_step = 0
        self.acc: Optional[list] = None

    def add(self, grads) -> bool:
        """Fold ``grads`` in; True when the update is due (the mean is then
        in the parameters' ``.grad``)."""
        if self.k == 1:
            return True
        if self.acc is None:
            self.acc = [torch.zeros_like(p) for p in self.params]
        n = self.mini_step
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / (n + 1))
        self.mini_step += 1
        if self.mini_step < self.k:
            return False
        for p, a in zip(self.params, self.acc):
            p.grad = a
        self.acc, self.mini_step = None, 0
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"mini_step": self.mini_step,
                "acc": None if self.acc is None else [a.clone() for a in self.acc]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.mini_step = int(state["mini_step"])
        self.acc = None if state["acc"] is None else [
            a.to(p.device).clone() for a, p in zip(state["acc"], self.params)]


def _mean_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The losses averaged over data-parallel ranks (the gradient norms are
    already the averaged gradients')."""
    losses = mesh.mean_scalars({k: v for k, v in metrics.items() if not k.startswith("grad/")})
    return {**metrics, **losses}


def aux_weight(model, step: int) -> float:
    """The auxiliary loss's weight at ``step`` (JAX ``make_gan_train_step``):
    a linear ramp from ``start_step`` over ``warmup_steps``, or a switch at
    ``start_step`` without a warm-up."""
    sched = model.losses_kwargs.get("aux_loss_schedule") or {}
    start, warmup = sched.get("start_step", 0), sched.get("warmup_steps", 0)
    if warmup > 0:
        return min(max((step - start) / warmup, 0.0), 1.0)
    return 1.0 if step >= start else 0.0


def _sharded(model, params) -> list:
    """Which of ``params`` are tensor-parallel shards."""
    dims = tp.param_dims(model)
    return [id(p) in dims for p in params]


class TrainStep:
    """Applies steps to ``model`` (a plain UNIVERSE built with its losses,
    or a model of the enhancement family) in place.  ``opt`` updates the
    parameters that require a gradient; ``lr`` maps its count of applied
    updates to its learning rate; ``clipper`` (``optim.make_clipper``)
    clips the gradients as one group; ``accumulate`` calls make one update.
    ``step`` and ``updates`` count steps and applied updates."""

    def __init__(self, model: Universe, opt: torch.optim.Optimizer,
                 lr: Callable[[int], float], ema: Optional[EMA] = None,
                 clipper=None, accumulate: int = 1):
        self.model = model
        self.opt, self.lr = opt, lr
        self.ema = ema
        self.clipper = clipper
        self.nan_guard = bool(model.train_kwargs.get("nan_guard", False))
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.sharded = _sharded(model, self.params)
        self.accum = GradAccumulator(self.params, accumulate)
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
        params = self.params
        for p in params:
            p.grad = None
        # only the diffusion models sample time adaptively
        kw = ({"pr_cum": (adaptive or {}).get("pr_cum"), "bins": (adaptive or {}).get("bins")}
              if isinstance(model, Universe) else {})
        rows = mesh.local_rows(batch["noisy"].shape[0])
        if rows is not None:
            kw["rows"] = rows
        loss, metrics = model.training_losses(batch["noisy"], batch["clean"], generator,
                                              draws, **kw)
        loss.backward()
        # a parameter the loss does not reach has a zero gradient, as in
        # jax.grad: AdamW then still decays it
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        mesh.all_mean_(grads, self.sharded)
        # nothing is updated before the check but AutoClip's history
        saved = (copy.deepcopy(self.clipper.__dict__)
                 if self.nan_guard and isinstance(self.clipper, AutoClipper) else None)
        if self.clipper is not None:
            gnorm, clip = self.clipper(grads, self.sharded)
            metrics["grad/norm"] = gnorm
            metrics["grad/clipped_norm"] = torch.minimum(gnorm, clip.to(gnorm.device))
        else:
            metrics["grad/norm"] = global_norm(grads, self.sharded)
        metrics = _mean_metrics({**metrics, "_loss": loss})
        ok = True
        if self.nan_guard:
            ok = bool(torch.isfinite(torch.stack([metrics["_loss"],
                                                  metrics["grad/norm"]])).all())
            metrics["train/update_skipped"] = torch.tensor(0.0 if ok else 1.0)
        del metrics["_loss"]
        if ok:
            if self.accum.add(grads):
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
    optimizer's count of applied updates to its learning rate;
    ``accumulate`` calls make one update of each.  ``step``,
    ``gen_updates`` and ``disc_updates`` count steps and applied updates.
    """

    def __init__(self, model: UniverseGAN, opt_gen: torch.optim.Optimizer,
                 opt_disc: torch.optim.Optimizer, lr_gen: Callable[[int], float],
                 lr_disc: Callable[[int], float], ema: Optional[EMA] = None,
                 grad_clip_vals: Optional[dict] = None, accumulate: int = 1):
        self.model = model
        self.opt_gen, self.opt_disc = opt_gen, opt_disc
        self.lr_gen, self.lr_disc = lr_gen, lr_disc
        self.ema = ema
        self.clip_vals = grad_clip_vals or {}
        self.nan_guard = bool(model.train_kwargs.get("nan_guard", False))
        self.mpd, self.mrd = _params(model, ["loss_mpd"]), _params(model, ["loss_mrd"])
        self.score_p = _params(model, ["score_model"])
        self.cond_p = _params(model, [k for k in model.model_param_keys()
                                      if k != "score_model"])
        self.sharded = {name: _sharded(model, ps) for name, ps in (
            ("mpd", self.mpd), ("mrd", self.mrd), ("score", self.score_p), ("cond", self.cond_p))}
        self.gen_accum = GradAccumulator(self.score_p + self.cond_p, accumulate)
        self.disc_accum = GradAccumulator(self.mpd + self.mrd, accumulate)
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
        mpd, mrd, score_p, cond_p = self.mpd, self.mrd, self.score_p, self.cond_p
        sh = self.sharded
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
        rows = mesh.local_rows(mix.shape[0])
        gen_out = model.generator_forward(mix, target, target_original, generator,
                                          u=draws.get("u"), z=draws.get("z"),
                                          pr_cum=adaptive.get("pr_cum"),
                                          bins=adaptive.get("bins"),
                                          dice=draws.get("dice"), rows=rows)
        if rows is not None:
            target_original = target_original[rows]

        zero = torch.zeros((), device=mix.device)
        disc_applied = disc_emitted = False
        saved = None
        if disc_frozen:
            l_disc, d_metrics, gnorm_mpd, gnorm_mrd = zero, {}, zero, zero
            adv_on = False
        else:
            l_disc, d_metrics = model.discriminator_losses(gen_out["y_est"].detach(),
                                                           target_original)
            l_disc.backward()
            mesh.all_mean_([p.grad for p in mpd + mrd], sh["mpd"] + sh["mrd"])
            gnorm_mpd = clip_by_norm_([p.grad for p in mpd], self.clip_vals.get("mpd", 1000.0),
                                      sh["mpd"])
            gnorm_mrd = clip_by_norm_([p.grad for p in mrd], self.clip_vals.get("mrd", 1000.0),
                                      sh["mrd"])
            freeze = model.disc_freeze_step
            adv_on = disc_applied = self.step >= freeze if freeze > 0 else True
            if disc_applied:
                if self.nan_guard:
                    saved = ([p.detach().clone() for p in mpd + mrd],
                             copy.deepcopy(self.opt_disc.state_dict()),
                             self.disc_accum.state_dict())
                if self.disc_accum.add([p.grad for p in mpd + mrd]):
                    set_lr(self.opt_disc, self.lr_disc(self.disc_updates))
                    self.opt_disc.step()
                    disc_emitted = True

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
        mesh.all_mean_([p.grad for p in score_p + cond_p], sh["score"] + sh["cond"])
        gnorm_score = clip_by_norm_([p.grad for p in score_p],
                                    self.clip_vals.get("score", 1000.0), sh["score"])
        gnorm_cond = clip_by_norm_([p.grad for p in cond_p], self.clip_vals.get("cond", 1000.0),
                                   sh["cond"])

        metrics = {**d_metrics, **g_metrics, "grad/score": gnorm_score,
                   "grad/cond": gnorm_cond, "grad/mpd": gnorm_mpd, "grad/mrd": gnorm_mrd}
        if model.loss_aux is not None:
            metrics["train/aux_weight"] = torch.tensor(aux_weight(model, self.step))
        metrics = _mean_metrics({**metrics, "_l_disc": l_disc, "_l_gen": l_gen})
        l_disc, l_gen = metrics.pop("_l_disc"), metrics.pop("_l_gen")
        ok = True
        if self.nan_guard:
            ok = bool(torch.isfinite(torch.stack(
                [l_disc, l_gen, gnorm_score, gnorm_cond, gnorm_mpd, gnorm_mrd])).all())
            metrics["train/update_skipped"] = torch.tensor(0.0 if ok else 1.0)
        if ok:
            self.disc_updates += int(disc_emitted)
            if self.gen_accum.add([p.grad for p in score_p + cond_p]):
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
            self.disc_accum.load_state_dict(saved[2])
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}
