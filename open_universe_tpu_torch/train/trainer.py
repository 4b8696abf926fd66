"""The training loop for UNIVERSE++ (the GAN branch of the JAX package's
``train/trainer.py``).

``Trainer`` draws the model's weights from the seed, builds the two AdamW
optimizers with the reference's schedule (``train/optim.py``), EMA and the
GAN step (``train/steps.py``), and ``fit`` takes steps from the
datamodule's train loader, runs the disc-frozen step before
``losses.disc_freeze_step``, logs every ``log_every`` steps (losses, step
time, peak device memory) to the log and to ``metrics.jsonl`` in the run
directory, and writes a reference-layout checkpoint every
``checkpoint_every`` steps and at the end: ``checkpoints/step_<n>.ckpt``
holding ``state_dict`` (discriminators included) and the EMA shadow list in
``inference/model_loader.py::ordered_param_names`` order, with the run's
config beside it as ``checkpoints/config.yaml``, where ``load_model`` looks.

Not ported (ROADMAP queue 1 item 11): validation and test (they need the
metrics), the adaptive time-sampling histogram, resume, gradient
accumulation and multi-device training.  ``fit`` raises rather than train
past a step where validation is due.
"""
from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import yaml

from ..inference.model_loader import ordered_param_names
from ..models.universe_gan import UniverseGAN
from ..nn.layers import init_weights
from ..utils.device import resolve_device
from .ema import EMA
from .optim import adamw, build_schedule
from .steps import GANTrainStep

log = logging.getLogger(__name__)


def make_gan_step(model: UniverseGAN, max_steps: int) -> GANTrainStep:
    """The GAN step of ``model``'s config as it stands: AdamW for the
    generator (weight decay by name) and for the discriminators, each with
    its schedule, and EMA from the current weights."""
    opt = model.opt_kwargs or {}
    if opt.get("accumulate_grad_batches", 1) not in (None, 1):
        raise NotImplementedError("gradient accumulation is not ported (ROADMAP queue 1)")
    gen_cfg, disc_cfg = opt.get("generator", {}), opt.get("discriminator", {})
    sch = model.schedule_kwargs or {}
    freeze = model.disc_freeze_step

    def named(keys):
        return [(f"{k}.{n}", p) for k in keys for n, p in getattr(model, k).named_parameters()]

    opt_gen = adamw(named(model.optimized_param_keys()),
                    betas=gen_cfg.get("betas", (0.8, 0.99)),
                    weight_decay=gen_cfg.get("weight_decay", 0.0),
                    weight_decay_exclude=gen_cfg.get("weight_decay_exclude",
                                                     ("prelu", "bias")))
    # the reference's discriminator config gives no weight decay, so its
    # torch AdamW decays every parameter, biases too, at the default 0.01
    opt_disc = adamw(named(model.disc_param_keys()),
                     betas=disc_cfg.get("betas", (0.8, 0.99)),
                     weight_decay=disc_cfg.get("weight_decay", 0.01),
                     weight_decay_exclude=None)
    ema_decay = model.train_kwargs.get("ema_decay", 0.0)
    return GANTrainStep(
        model, opt_gen, opt_disc,
        build_schedule(sch.get("generator"), gen_cfg.get("lr", 2e-4), max_steps,
                       gan_role="generator", freeze_step=freeze),
        build_schedule(sch.get("discriminator"), disc_cfg.get("lr", 2e-4), max_steps,
                       gan_role="discriminator", freeze_step=freeze),
        ema=EMA(model, ema_decay) if ema_decay > 0.0 else None,
        grad_clip_vals=opt.get("grad_clip_vals", {}))


class Trainer:
    def __init__(self, model: UniverseGAN, datamodule, output_dir,
                 max_steps: int = 600_000, val_check_interval: int = 5000,
                 seed: int = 0, log_every: int = 25,
                 checkpoint_every: Optional[int] = None,
                 config: Optional[dict] = None, device=None):
        if not isinstance(model, UniverseGAN) or not hasattr(model, "loss_mpd"):
            raise NotImplementedError(
                "the port trains a UniverseGAN built with its losses "
                "(configs/registry.py::instantiate_trainable) only")
        self.model = model
        self.dm = datamodule
        self.output_dir = Path(output_dir)
        self.max_steps = max_steps
        self.val_check_interval = val_check_interval
        self.seed = seed
        self.log_every = log_every
        self.checkpoint_every = checkpoint_every or val_check_interval
        self.config = config
        self.device = resolve_device(device)
        (self.output_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
        if config is not None:
            with open(self.output_dir / "checkpoints" / "config.yaml", "w") as f:
                yaml.safe_dump(config, f)
        self._setup()

    def _setup(self):
        init_weights(self.model, self.seed).to(self.device).train()
        self.step_fn = make_gan_step(self.model, self.max_steps)
        self.ema = self.step_fn.ema

    # ------------------------------------------------------------------
    def _log(self, metrics: Dict[str, Any], step: int):
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        with open(self.output_dir / "metrics.jsonl", "a") as f:
            f.write(json.dumps(row) + "\n")
        log.info("step %d loss_gen %.4f loss_disc %.4f (%.3f s/step, peak %.2f GiB)",
                 step, row.get("train/loss_gen", float("nan")),
                 row.get("train/loss_disc", float("nan")),
                 row["perf/step_time_s"], row.get("perf/peak_mem_gib", 0.0))

    def fit(self) -> Dict[str, float]:
        """Train to ``max_steps``; returns the last step's metrics."""
        step = self.step_fn.step
        due = [s for s in range(step + 1, self.max_steps + 1)
               if s % self.val_check_interval == 0]
        if due:
            raise NotImplementedError(
                f"validation is due at step {due[0]} (trainer.val_check_interval="
                f"{self.val_check_interval}) and is not ported (ROADMAP queue 1 "
                "item 11); set trainer.val_check_interval above trainer.max_steps")
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        loader = self.dm.train_dataloader()
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        metrics: Dict[str, Any] = {}
        t0 = time.perf_counter()
        log.info("starting training at step %d / %d on %s", step, self.max_steps,
                 self.device)
        while step < self.max_steps:
            for batch in loader:
                if step >= self.max_steps:
                    break
                b = {k: torch.from_numpy(np.asarray(batch[k])).to(self.device)
                     for k in ("noisy", "clean")}
                metrics = self.step_fn(b, generator=gen,
                                       disc_frozen=step < self.model.disc_freeze_step)
                step += 1
                if step % self.log_every == 0 or step == self.max_steps:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    if cuda:
                        torch.cuda.synchronize(self.device)
                        metrics["perf/peak_mem_gib"] = (
                            torch.cuda.max_memory_allocated(self.device) / 2**30)
                    n = step % self.log_every or self.log_every
                    metrics["perf/step_time_s"] = (time.perf_counter() - t0) / n
                    t0 = time.perf_counter()
                    self._log(metrics, step)
                if step % self.checkpoint_every == 0 and step != self.max_steps:
                    self.save(step)
        self.save(step)
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------------
    def save(self, step: int) -> Path:
        """Write ``checkpoints/step_<step>.ckpt`` in the reference's layout."""
        sd = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
        ckpt: Dict[str, Any] = {"state_dict": sd, "global_step": step}
        if self.ema is not None:
            names = ordered_param_names(sd, self.model.model_param_keys())
            ckpt["ema"] = {"shadow_params": [self.ema.shadow[n].cpu() for n in names],
                           "decay": self.ema.decay,
                           "num_updates": self.ema.num_updates}
        path = self.output_dir / "checkpoints" / f"step_{step:08d}.ckpt"
        torch.save(ckpt, path)
        log.info("saved checkpoint %s", path)
        return path
