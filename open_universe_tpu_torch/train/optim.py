"""Optimizers, LR schedules and gradient clipping (JAX package
``train/optim.py``).

* ``linear_warmup_cosine_annealing``: the reference's
  LinearWarmupCosineAnnealingLR (linear warmup eta_min -> base over
  T_warmup, flat until T_cosine, cosine to eta_min at T_max), held at
  eta_min past T_max.
* ``build_schedule``: the GAN trainer's use of it, two scheduler units per
  step (the reference steps both schedulers after each optimizer).
* ``adamw``: ``torch.optim.AdamW`` with one group that decays and one that
  does not, by name; its update is optax's scale_by_adam, then the decayed
  weights, then the learning rate, which the JAX package chains.
* ``clip_by_norm_``: the JAX package's clipping rule, scale
  min(1, max / max(norm, 1e-12)) (not ``clip_grad_norm_``'s
  max / (norm + 1e-6)); ``FixedClipper`` and ``AutoClipper`` use it, and
  ``make_clipper`` builds one from a ``grad_clipper`` config node.  The
  norm is of the whole gradients under tensor parallelism too: the steps
  flag the shards (``sharded``).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch

from ..parallel import tp


def linear_warmup_cosine_annealing(base_lr: float, t_warmup: int, t_cosine: int,
                                   t_max: int, eta_min: float = 0.0
                                   ) -> Callable[[int], float]:
    """The learning rate after ``step`` scheduler units."""

    def schedule(step: int) -> float:
        step = min(float(step), float(t_max))
        if step <= t_warmup:
            return eta_min + (base_lr - eta_min) * step / max(t_warmup, 1)
        if step <= t_cosine:
            return base_lr
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos((step - t_cosine) * math.pi / max(t_max - t_cosine, 1)))

    return schedule


def gan_scheduler_units(step: int, freeze_step: int = 0) -> int:
    """Scheduler units the GAN trainer has used at train step ``step``: two
    per step with the discriminator active, one per step of the disc-freeze
    phase.  Use it to turn a train step into a T_warmup / T_cosine / T_max
    horizon."""
    if freeze_step <= 0:
        return 2 * step
    if step <= freeze_step:
        return step
    return freeze_step + 2 * (step - freeze_step)


def build_schedule(sch_cfg: Optional[dict], base_lr: float, max_steps: int,
                   gan_role: Optional[str] = None, freeze_step: int = 0
                   ) -> Callable[[int], float]:
    """The learning rate as a function of the optimizer's own update count.

    With F = disc_freeze_step the generator's i-th update runs at
    sched(min(i, F) + 2 max(i - F, 0) + [i >= F]) and the discriminator's
    d-th at sched(F + 2d): the reference steps both schedulers after the
    disc update and after the gen update, and only after the gen update
    while the discriminator is frozen."""
    if sch_cfg is None:
        return lambda i: base_lr
    inner = sch_cfg.get("scheduler", sch_cfg)
    t_max = inner.get("T_max", max_steps) or max_steps
    sched = linear_warmup_cosine_annealing(
        base_lr, inner.get("T_warmup", 0), inner.get("T_cosine", t_max), t_max,
        inner.get("eta_min", 0.0))
    if gan_role is None:
        return sched
    if gan_role == "generator":
        return lambda i: sched(min(i, freeze_step) + 2 * max(i - freeze_step, 0)
                               + int(i >= freeze_step))
    if gan_role == "discriminator":
        return lambda d: sched(freeze_step + 2 * d)
    raise ValueError(gan_role)


def adamw(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
          betas=(0.8, 0.99), weight_decay: float = 0.01,
          weight_decay_exclude: Optional[Sequence[str]] = ("prelu", "bias")
          ) -> torch.optim.AdamW:
    """AdamW whose weight decay skips every parameter whose name holds one of
    ``weight_decay_exclude`` (none with None).  The learning rate is set
    per update by the caller (``set_lr``)."""
    exclude = list(weight_decay_exclude or ())
    decay, no_decay = [], []
    for name, p in named_params:
        (no_decay if any(kw in name for kw in exclude) else decay).append(p)
    groups = [{"params": ps, "weight_decay": wd}
              for ps, wd in ((decay, weight_decay), (no_decay, 0.0)) if ps]
    return torch.optim.AdamW(groups, lr=0.0, betas=tuple(betas), eps=1e-8)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def global_norm(grads: Sequence[torch.Tensor],
                sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """The norm of the whole gradients: those flagged in ``sharded`` are
    tensor-parallel shards, whose squares are summed over the tp ranks
    (``parallel/tp.py::sum_squares``)."""
    if sharded is not None and any(sharded):
        return torch.sqrt(tp.sum_squares(grads, sharded))
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))


def _scale_(grads: Sequence[torch.Tensor], norm: torch.Tensor, max_norm) -> None:
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def clip_by_norm_(grads: Sequence[torch.Tensor], max_norm,
                  sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Scale ``grads`` in place by min(1, max_norm / max(norm, 1e-12)) of
    their global norm (``global_norm``), which is returned."""
    grads = list(grads)
    if not grads:
        return torch.zeros(())
    norm = global_norm(grads, sharded)
    _scale_(grads, norm, max_norm)
    return norm


class FixedClipper:
    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def __call__(self, grads: Sequence[torch.Tensor],
                 sharded: Optional[Sequence[bool]] = None):
        """Clip in place; returns (norm, clip norm)."""
        return (clip_by_norm_(grads, self.max_norm, sharded),
                torch.tensor(float(self.max_norm)))


class AutoClipper:
    """AutoClip (Seetharaman et al. 2020): clip at the p-th percentile of
    the norms seen so far, over a ring buffer of ``history_size``."""

    def __init__(self, p: float, history_size: int = 10000):
        self.p = p / 100.0
        self.history = torch.full((history_size,), math.inf)
        self.count = 0

    def __call__(self, grads: Sequence[torch.Tensor],
                 sharded: Optional[Sequence[bool]] = None):
        grads = list(grads)
        norm = global_norm(grads, sharded)
        size = self.history.shape[0]
        self.history = self.history.to(norm.device)
        self.history[self.count % size] = norm
        self.count += 1
        n = min(self.count, size)
        clip = torch.sort(self.history).values[min(max(int(self.p * n), 0), n - 1)]
        _scale_(grads, norm, clip)
        return norm, clip


def make_clipper(cfg: Optional[dict]):
    """The clipper of a ``grad_clipper`` node (``max_norm``: fixed; ``p``:
    AutoClip), or None."""
    if not cfg:
        return None
    cfg = {k: v for k, v in cfg.items() if not k.startswith("_")}
    if "max_norm" in cfg:
        return FixedClipper(cfg["max_norm"])
    if "p" in cfg:
        return AutoClipper(cfg["p"], cfg.get("history_size", 10000))
    raise ValueError(f"unknown clipper config {cfg}")
