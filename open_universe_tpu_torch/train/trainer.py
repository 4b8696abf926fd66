"""The training loop for the plain UNIVERSE, UNIVERSE++ and LoRA fine-tuning
(JAX package ``train/trainer.py``).

``Trainer`` draws the model's weights from the seed (a ``UniverseLoRA``
keeps the checkpoint's weights and its adapters' draws) and builds its step
(``train/steps.py``): for UNIVERSE++ the GAN step with two AdamW optimizers
(generator, discriminators), each with the reference's schedule
(``train/optim.py``); for the plain UNIVERSE and the enhancement family the
single-optimizer step with one AdamW over every parameter that requires a
gradient (the plain UNIVERSE's MDN loss modules included; LoRA's adapters
and biases), one schedule (constant without ``scheduler``) and the
``grad_clipper``'s clipper; EMA of ``model_param_keys()`` for all.
``fit`` takes steps from the datamodule's train loader, runs the
disc-frozen GAN step before ``losses.disc_freeze_step``, logs every
``log_every`` steps (losses, step time, peak device memory) to the log and
to ``metrics.jsonl`` in the run directory, validates every
``val_check_interval`` steps, and writes a checkpoint every
``checkpoint_every`` steps and at the end.

Validation (``validate``) and ``test`` run on one copy of the model per call
(its loss modules left out) with the EMA shadow as its weights and weight
norm folded, without autograd, so every ConvBlock takes the fused kernel on
the card (none does while LoRA adapters are attached).  The enhancement
family validates with its own loss stack (``_validate_enhancement``: the
mean of ``validation_losses`` over the val batches, then ``enhance`` and
the metric suite as below).  The diffusion models' validation: the score
loss in each of ``validation.n_bins``
uniform time bins (``Universe.compute_losses(train=False)``), averaged over
the val batches (``val/score``, ``val/score_<lo>-<hi>``; they feed the
``adaptive`` time sampling's histogram), then ``enhance`` and the metric
suite of ``validation.enh_losses`` (``metrics.EvalMetrics``: ``val/lsd``,
``val/pesq``) on the first ``max_enh_batches`` batches.  Clips are
zero-padded to ``validation.bucket_seconds`` after normalisation.  The
draws come from a generator seeded with the reference's validation seed,
or from ``draws``.  ``test`` enhances the test split and writes
``test_results.json`` and ``test_summary.json`` (``bin/eval_metrics.py``'s
schema) to the run directory.

Checkpoints, ``checkpoints/step_<n>.ckpt``, are in the reference's layout:
``state_dict`` (loss modules included; a LoRA fine-tune's under ``model.``,
its EDM score network as ``model._edm_model.``), the EMA shadow list in
``inference/model_loader.py::ordered_param_names`` order, and, under
Lightning's key names, ``optimizer_states`` (one per optimizer: the
generator's, then the discriminators') and ``lr_schedulers`` (each
optimizer's count of updates, on which its learning rate depends); the
run's config is beside them as ``config.yaml``, where ``load_model``
looks.  ``last.json`` points at the newest checkpoint, ``index.json`` lists
every checkpoint with the newest validation's ``validation.main_loss`` and
``best.json`` the best of them by ``main_loss_mode``.  ``restore``
(``fit(resume_from=...)``) resumes from a ``.ckpt`` or a run directory's
``last.json``; the resumed run restarts its loader and its generator from
the seed, as the JAX trainer does, and AutoClip's history (the plain
UNIVERSE's ``grad_clipper: {p: ...}``) empty.  With
``optimizer.accumulate_grad_batches`` > 1 the checkpoint also holds each
optimizer's gradient accumulator (``grad_accumulators``: its running mean
and count), so a run resumed in the middle of an accumulation continues it.

Data parallelism (``parallel/mesh.py``, under ``torchrun``): every rank
draws the same weights and takes every step on its dp group's rows of the
same global batch; only rank 0 logs, validates, tests and writes
checkpoints and the json files beside them, then sends the adaptive
histogram to the others, which wait at a barrier.  On resume every rank
loads the checkpoint.  Tensor parallelism (``trainer.mesh_tp`` > 1,
``parallel/tp.py``): after drawing the weights each rank keeps its slices
of the parameters that JAX's rule shards (``tp_min_shard``, JAX's
``min_last``), so its moments, accumulators and EMA shadows are slices too;
``validate``, ``test`` and ``save`` are called on every rank, which gather
the shards together, and rank 0 alone validates, tests and writes (full
tensors: the checkpoint is a one-process run's); ``restore`` cuts a full
checkpoint to the rank's slices, so a run resumes at any tp.
``profile_steps=(start, stop)`` traces steps start..stop-1 with
``torch.profiler`` into ``<run>/profile`` (JAX's ``jax.profiler`` trace),
the port's spans (``utils/spans.py``) among its host ops.
"""
from __future__ import annotations

import copy
import json
import logging
import math
import re
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from ..inference.model_loader import normalize_key, ordered_param_names
from ..models.enhancement import EnhancementBaseModel
from ..models.universe import Universe
from ..models.universe_gan import UniverseGAN
from ..models.universe_lora import UniverseLoRA
from ..nn.layers import init_weights
from ..parallel import mesh, tp
from ..utils import spans
from ..utils.convert import fold_weight_norm
from ..utils.device import resolve_device
from .ema import EMA
from .optim import adamw, build_schedule, make_clipper
from .steps import GANTrainStep, TrainStep

log = logging.getLogger(__name__)

VAL_SEED = 682479040  # reference universe.py:604


def make_gan_step(model: UniverseGAN, max_steps: int) -> GANTrainStep:
    """The GAN step of ``model``'s config as it stands: AdamW for the
    generator (weight decay by name) and for the discriminators, each with
    its schedule, and EMA from the current weights."""
    opt = model.opt_kwargs or {}
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
        grad_clip_vals=opt.get("grad_clip_vals", {}),
        accumulate=opt.get("accumulate_grad_batches") or 1)


def make_train_step(model, max_steps: int) -> TrainStep:
    """The single-optimizer step of a plain UNIVERSE's or an enhancement
    model's config as it stands: one AdamW over every parameter that
    requires a gradient (weight decay by name), its schedule, the
    ``grad_clipper``'s clipper and EMA from the current weights (JAX
    ``Trainer._setup``'s non-GAN branch, whose trainable mask is the
    ``requires_grad`` here).  ``universe_lora.yaml`` names torch's Adam;
    like the JAX trainer this builds AdamW from its lr and weight_decay."""
    opt = dict(model.opt_kwargs or {})
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    optimizer = adamw(trainable, betas=opt.get("betas", (0.8, 0.99)),
                      weight_decay=opt.get("weight_decay", 0.0),
                      weight_decay_exclude=opt.get("weight_decay_exclude", ("prelu", "bias")))
    ema_decay = model.train_kwargs.get("ema_decay", 0.0)
    return TrainStep(model, optimizer,
                     build_schedule(model.schedule_kwargs, opt.get("lr", 2e-4), max_steps),
                     ema=EMA(model, ema_decay) if ema_decay > 0.0 else None,
                     clipper=make_clipper(model.grad_clip_kwargs),
                     accumulate=opt.get("accumulate_grad_batches") or 1)


def make_step(model, max_steps: int):
    """The training step of ``model``: the GAN step for UNIVERSE++, the
    single-optimizer step for the plain UNIVERSE and the enhancement
    family."""
    if isinstance(model, UniverseGAN):
        return make_gan_step(model, max_steps)
    return make_train_step(model, max_steps)


def optimizers(step_fn):
    """(optimizer, name of its update counter, its gradient accumulator) of
    a step, in checkpoint order."""
    if isinstance(step_fn, GANTrainStep):
        return [(step_fn.opt_gen, "gen_updates", step_fn.gen_accum),
                (step_fn.opt_disc, "disc_updates", step_fn.disc_accum)]
    return [(step_fn.opt, "updates", step_fn.accum)]


class Trainer:
    def __init__(self, model: Universe, datamodule, output_dir,
                 max_steps: int = 600_000, val_check_interval: int = 5000,
                 seed: int = 0, log_every: int = 25,
                 checkpoint_every: Optional[int] = None,
                 max_val_batches: Optional[int] = None,
                 config: Optional[dict] = None, device=None,
                 profile_steps: Optional[tuple] = None, tp_min_shard: int = 128):
        if not (isinstance(model, EnhancementBaseModel)
                or isinstance(model, Universe) and model.built_for_training):
            raise NotImplementedError(
                "the port trains a Universe, UniverseGAN or UniverseLoRA built with its "
                "training nodes (configs/registry.py::instantiate_trainable) only")
        self.model = model
        self.dm = datamodule
        self.output_dir = Path(output_dir)
        self.max_steps = max_steps
        self.val_check_interval = val_check_interval
        self.seed = seed
        self.log_every = log_every
        self.checkpoint_every = checkpoint_every or val_check_interval
        self.max_val_batches = max_val_batches
        self.config = config
        self.device = resolve_device(device)
        self.profile_steps = profile_steps
        self.tp_min_shard = tp_min_shard  # the narrowest last JAX axis tp shards
        self._last_val: Dict[str, float] = {}
        self._first_val_done = False
        self.val_timing: Dict[str, float] = {}
        if mesh.is_main():
            (self.output_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
            if config is not None:
                with open(self.output_dir / "checkpoints" / "config.yaml", "w") as f:
                    yaml.safe_dump(config, f)
        self._setup()

    def _setup(self):
        from ..configs.registry import instantiate

        if not isinstance(self.model, UniverseLoRA):
            init_weights(self.model, self.seed)
        self.model.to(self.device).train()
        tp.shard_(self.model, self.tp_min_shard)  # this rank's slices (none without tp)
        self.step_fn = make_step(self.model, self.max_steps)
        self.ema = self.step_fn.ema
        # the metric suite of validation and test (EvalMetrics by default)
        self.enh_losses = {}
        for name, cfg in (self.model.val_kwargs.get("enh_losses") or {}).items():
            try:
                self.enh_losses[name] = instantiate(cfg) if isinstance(cfg, dict) else cfg
            except Exception as e:
                log.warning("enh loss %s unavailable: %s", name, e)
        # the adaptive time sampling's histogram (reference universe.py:391-412,
        # 630-638), uniform until the first validation
        self._adaptive_mode = self.model.train_kwargs.get("time_sampling") == "adaptive"
        tb = np.linspace(0.0, 1.0, self.model.val_kwargs.get("n_bins", 5) + 1)
        pr_cum = tb.copy()
        pr_cum[-1] = 1.0 + 1e-5
        self.pr_cum = torch.tensor(pr_cum, dtype=torch.float32, device=self.device)
        self.val_bins = torch.tensor(tb, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    def _log(self, metrics: Dict[str, Any], step: int):
        if not mesh.is_main():
            return
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        with open(self.output_dir / "metrics.jsonl", "a") as f:
            f.write(json.dumps(row) + "\n")
        if "perf/step_time_s" in row:
            losses = " ".join(f"{k[6:]} {row[k]:.4f}" for k in (
                "train/loss", "train/loss_gen", "train/loss_disc", "train/main_loss")
                if k in row)
            log.info("step %d %s (%.3f s/step, peak %.2f GiB)", step, losses,
                     row["perf/step_time_s"], row.get("perf/peak_mem_gib", 0.0))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, resume_from: Optional[str] = None) -> Dict[str, float]:
        """Train to ``max_steps`` (from the checkpoint ``resume_from``
        points at, if given); returns the last step's metrics."""
        if resume_from:
            self.restore(resume_from)
        step = self.step_fn.step
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        loader = self.dm.train_dataloader()
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        metrics: Dict[str, Any] = {}
        t0 = time.perf_counter()
        log.info("starting training at step %d / %d on %s (rank %d of %d)", step,
                 self.max_steps, self.device, mesh.rank(), mesh.world_size())
        prof = None
        while step < self.max_steps:
            for batch in loader:
                if step >= self.max_steps:
                    break
                b = {k: torch.from_numpy(np.asarray(batch[k])).to(self.device)
                     for k in ("noisy", "clean")}
                adaptive = ({"pr_cum": self.pr_cum, "bins": self.val_bins}
                            if self._adaptive_mode else None)
                kw = ({"disc_frozen": step < self.model.disc_freeze_step}
                      if isinstance(self.step_fn, GANTrainStep) else {})
                if self.profile_steps and step == self.profile_steps[0]:
                    prof = self._start_profile()
                metrics = self.step_fn(b, generator=gen, adaptive=adaptive, **kw)
                step += 1
                if prof is not None and step == self.profile_steps[1]:
                    self._stop_profile(prof)
                    prof = None
                if step % self.log_every == 0 or step == self.max_steps:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    if cuda:
                        self._sync()
                        metrics["perf/peak_mem_gib"] = (
                            torch.cuda.max_memory_allocated(self.device) / 2**30)
                    n = step % self.log_every or self.log_every
                    metrics["perf/step_time_s"] = (time.perf_counter() - t0) / n
                    t0 = time.perf_counter()
                    self._log(metrics, step)
                if step % self.val_check_interval == 0:
                    t_val = time.perf_counter()
                    self._last_val = self.validate(step)  # rank 0's
                    self._log({**self._last_val, **self.val_timing}, step)
                    self._share_validation()
                    t0 += time.perf_counter() - t_val  # not a step's time
                if step % self.checkpoint_every == 0 and step != self.max_steps:
                    t_save = time.perf_counter()
                    self.save(step)
                    t0 += time.perf_counter() - t_save  # not a step's time either
        if prof is not None:
            self._stop_profile(prof)
        self.save(step)
        return {k: float(v) for k, v in metrics.items()}

    def _share_validation(self):
        """Rank 0's validation results (the adaptive histogram, the main
        loss of the next checkpoints) on every rank; the others wait."""
        pr_cum, bins, last = mesh.broadcast_object(
            (self.pr_cum.cpu(), self.val_bins.cpu(), self._last_val))
        self.pr_cum, self.val_bins = pr_cum.to(self.device), bins.to(self.device)
        self._last_val = last

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof):
        self._sync()
        prof.stop()
        out = self.output_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"trace_rank{mesh.rank()}.json"
        prof.export_chrome_trace(str(path))
        # the trace carries the spans as host ops; their records have no
        # reader in training
        spans.clear()
        log.info("profiler trace written to %s", path)

    # ------------------------------------------------------------------
    def _eval_model(self) -> Optional[Universe]:
        """A copy of the model (its loss modules left out: the
        discriminators or the MDN losses) with the EMA shadow as its
        weights, whole (every tp rank gathers its shards into it), weight
        norm folded, in eval mode and without gradients: the model
        validation and test run on rank 0, whose ConvBlocks the fused
        kernel takes; None on the other ranks.  A LoRA fine-tune keeps its
        kept discriminators (its validation loss uses them) and its
        adapters, so its ConvBlocks run unfused."""
        m = self.model
        if not (mesh.is_main() or tp.dims(m)):
            return None
        skip = {id(getattr(m, k)): None for k in m.loss_param_keys()}
        ev = copy.deepcopy(m, skip)
        if self.ema is not None:
            self.ema.apply_to(ev)
        tp.unshard_(ev)
        if not mesh.is_main():
            return None
        for mod in ev.modules():
            if isinstance(mod, torch.nn.RNNBase):
                mod.flatten_parameters()  # as .to() leaves them; a copy does not
        return fold_weight_norm(ev).requires_grad_(False).eval()

    def _pad_to_bucket(self, x: torch.Tensor) -> torch.Tensor:
        """Zero-pad (B, T, C) up to a multiple of ``validation.bucket_seconds``
        (default 1 s)."""
        bucket = self.model.val_kwargs.get("bucket_seconds", 1.0)
        t = x.shape[1]
        step_len = max(int(round(bucket * self.model.fs)), 1)
        t_pad = int(math.ceil(t / step_len) * step_len)
        return F.pad(x, (0, 0, 0, t_pad - t)) if t_pad != t else x

    def _bucketed_enhance(self, model, mix, generator=None, noise=None):
        """``enhance`` of mix padded up to its length bucket, cut back."""
        t = mix.shape[1]
        kw = {} if noise is None else {"noise": noise}
        return model.enhance(self._pad_to_bucket(mix), generator=generator, **kw)[:, :t]

    def _enhance_and_score(self, model, step, bi, batch, mix, target, generator,
                           noise, enh_metrics, timing):
        """Enhance one val batch and run the metric suite on it (reference
        base.py:408-478 / universe.py:640-704)."""
        t0 = time.perf_counter()
        est = self._bucketed_enhance(model, mix, generator, noise)  # (B, T, 1)
        self._sync()
        t1 = time.perf_counter()
        est_b, tgt_b = est[:, :, 0][:, None, :], target[:, :, 0][:, None, :]
        self._log_audio_samples(step, bi, np.asarray(batch["noisy"]),
                                tgt_b.cpu().numpy(), est_b.cpu().numpy())
        for name, loss in self.enh_losses.items():
            vals = loss(est_b, tgt_b)
            if not isinstance(vals, dict):
                vals = {"": vals}
            for sub_name, v in vals.items():
                enh_metrics.setdefault(name + sub_name, []).append(float(v))
        timing["model_s"] += t1 - t0
        timing["enhance_s"] += t1 - t0
        timing["metrics_s"] += time.perf_counter() - t1

    @torch.no_grad()
    def validate(self, step: int, draws: Optional[Iterator[dict]] = None
                 ) -> Dict[str, float]:
        """The binned score losses and the enhancement metrics on the val
        split (JAX ``Trainer.validate``); updates the adaptive histogram.
        ``draws`` gives the random draws in the order validation takes them
        (for each batch one {"u", "z"} per bin, then {"noise"} for its
        ``enhance``; for the enhancement family one {"noise"} per batch for
        its ``validation_losses``, then {"noise"} for its ``enhance``);
        without it they come from a generator seeded with ``VAL_SEED``.  ``val_timing`` keeps the wall seconds: the model's
        passes (synchronised; the enhance calls among them) and the host
        metrics.  Under tensor parallelism every rank calls it (the shards
        are gathered together); the others return {}."""
        if not isinstance(self.model, Universe):
            return self._validate_enhancement(step, draws)
        t_start = time.perf_counter()
        model = self._eval_model()
        if model is None:
            return {}
        n_bins = model.val_kwargs.get("n_bins", 5)
        max_enh = model.val_kwargs.get("max_enh_batches", 4)
        gen = torch.Generator(device=self.device).manual_seed(VAL_SEED)
        tb = np.linspace(0.0, 1.0, n_bins + 1)
        bin_scores = np.zeros(n_bins)
        n_batches = 0
        enh_metrics: Dict[str, list] = {}
        timing = {"model_s": 0.0, "enhance_s": 0.0, "metrics_s": 0.0}

        for bi, batch in enumerate(self.dm.val_dataloader()):
            if self.max_val_batches is not None and bi >= self.max_val_batches:
                break
            t0 = time.perf_counter()
            mix = torch.from_numpy(np.asarray(batch["noisy"])).to(self.device)
            target = torch.from_numpy(np.asarray(batch["clean"])).to(self.device)
            (mix_n, target_n), *_ = model.normalize_batch((mix, target))
            # bucket pad AFTER normalisation (the statistics of the native
            # length batch); the score loss averages over the padded region
            # too, a uniform dilution that cancels in the histogram
            mix_p, _ = model.pad(self._pad_to_bucket(mix_n))
            target_p, _ = model.pad(self._pad_to_bucket(target_n))
            for i in range(n_bins):
                d = next(draws) if draws is not None else {}
                ls = model.compute_losses(mix_p, target_p, train=False,
                                          t_min=float(tb[i]), t_max=float(tb[i + 1]),
                                          generator=gen, u=d.get("u"), z=d.get("z"))
                bin_scores[i] += float(ls)
            n_batches += 1
            timing["model_s"] += time.perf_counter() - t0

            if bi < max_enh and self.enh_losses:
                d = next(draws) if draws is not None else {}
                self._enhance_and_score(model, step, bi, batch, mix, target, gen,
                                        d.get("noise"), enh_metrics, timing)

        metrics: Dict[str, float] = {}
        if n_batches:
            bin_scores /= n_batches
            metrics["val/score"] = float(np.mean(bin_scores))
            for i in range(n_bins):
                metrics[f"val/score_{tb[i]:.2f}-{tb[i + 1]:.2f}"] = float(bin_scores[i])
            # the adaptive time sampling's histogram (universe.py:630-638)
            v = np.maximum(bin_scores, 5e-4)
            pr_cum = np.concatenate([[0.0], np.cumsum(v)])
            pr_cum /= pr_cum[-1]
            pr_cum[-1] = 1.0 + 1e-5
            self.pr_cum = torch.tensor(pr_cum, dtype=torch.float32, device=self.device)
            self.val_bins = torch.tensor(tb, dtype=torch.float32, device=self.device)
        for k, vals in enh_metrics.items():
            metrics[k] = float(np.mean(vals))
        self.val_timing = {"perf/val_wall_s": time.perf_counter() - t_start,
                           **{f"perf/val_{k}": v for k, v in timing.items()}}
        log.info("validation @%d: %s (%s)", step,
                 {k: round(v, 4) for k, v in metrics.items()},
                 {k: round(v, 3) for k, v in self.val_timing.items()})
        return metrics

    def _validate_enhancement(self, step: int, draws: Optional[Iterator[dict]] = None
                              ) -> Dict[str, float]:
        """The enhancement family's validation (JAX
        ``Trainer._validate_enhancement``, reference enhancement/base.py:382-478):
        the mean of the model's ``validation_losses`` over the val batches
        (padded to their bucket), then ``enhance`` and the metric suite on
        the first ``max_enh_batches``."""
        t_start = time.perf_counter()
        model = self._eval_model()
        if model is None:
            return {}
        max_enh = model.val_kwargs.get("max_enh_batches", 4)
        gen = torch.Generator(device=self.device).manual_seed(VAL_SEED)
        loss_sums: Dict[str, float] = {}
        n_batches = 0
        enh_metrics: Dict[str, list] = {}
        timing = {"model_s": 0.0, "enhance_s": 0.0, "metrics_s": 0.0}
        for bi, batch in enumerate(self.dm.val_dataloader()):
            if self.max_val_batches is not None and bi >= self.max_val_batches:
                break
            t0 = time.perf_counter()
            mix = torch.from_numpy(np.asarray(batch["noisy"])).to(self.device)
            target = torch.from_numpy(np.asarray(batch["clean"])).to(self.device)
            d = next(draws) if draws is not None else {}
            _, vm = model.validation_losses(self._pad_to_bucket(mix),
                                            self._pad_to_bucket(target), generator=gen,
                                            draws=d)
            for k, v in vm.items():
                loss_sums[k] = loss_sums.get(k, 0.0) + float(v)
            n_batches += 1
            timing["model_s"] += time.perf_counter() - t0
            if bi < max_enh and self.enh_losses:
                d = next(draws) if draws is not None else {}
                self._enhance_and_score(model, step, bi, batch, mix, target, gen,
                                        d.get("noise"), enh_metrics, timing)
        metrics = {k: v / n_batches for k, v in loss_sums.items()} if n_batches else {}
        for k, vals in enh_metrics.items():
            metrics[k] = float(np.mean(vals))
        self.val_timing = {"perf/val_wall_s": time.perf_counter() - t_start,
                           **{f"perf/val_{k}": v for k, v in timing.items()}}
        log.info("validation @%d: %s (%s)", step,
                 {k: round(v, 4) for k, v in metrics.items()},
                 {k: round(v, 3) for k, v in self.val_timing.items()})
        return metrics

    # ------------------------------------------------------------------
    @torch.no_grad()
    def test(self, step: Optional[int] = None,
             draws: Optional[Iterator[dict]] = None) -> Dict[str, float]:
        """Test-set evaluation (reference train.py:105-119): enhance every
        test clip, run the metric suite, and write per-file results and
        their means to the run dir in ``bin/eval_metrics.py``'s schema.
        ``draws`` as in ``validate``: one {"noise"} per batch.  Under tensor
        parallelism every rank calls it; the others return {}."""
        from ..bin.eval_metrics import summarize

        if step is None:
            step = self.step_fn.step
        model = self._eval_model()
        if model is None:
            return {}
        gen = torch.Generator(device=self.device).manual_seed(VAL_SEED)
        results: Dict[str, Dict[str, float]] = {}
        for batch in self.dm.test_dataloader():
            mix = torch.from_numpy(np.asarray(batch["noisy"])).to(self.device)
            target = torch.from_numpy(np.asarray(batch["clean"])).to(self.device)
            d = next(draws) if draws is not None else {}
            est = self._bucketed_enhance(model, mix, gen, d.get("noise"))
            lengths = np.asarray(batch.get("length", [mix.shape[1]] * mix.shape[0]))
            keys = batch.get("key", [f"clip{len(results) + i}" for i in range(mix.shape[0])])
            for i, name in enumerate(keys):
                t_i = int(lengths[i])
                est_i = est[i, :t_i, 0][None, None, :]
                tgt_i = target[i, :t_i, 0][None, None, :]
                entry: Dict[str, float] = {}
                for lname, loss in self.enh_losses.items():
                    vals = loss(est_i, tgt_i)
                    if not isinstance(vals, dict):
                        vals = {"": vals}
                    for sub_name, v in vals.items():
                        entry[(lname + sub_name).replace("val/", "")] = float(v)
                results[str(name)] = entry

        summary = summarize(results)
        with open(self.output_dir / "test_results.json", "w") as f:
            json.dump(results, f, indent=2)
        with open(self.output_dir / "test_summary.json", "w") as f:
            json.dump(summary, f, indent=2)
        self._log({f"test/{k}": v for k, v in summary.items() if k != "number"}, step)
        log.info("test @%d over %d files: %s", step, int(summary.get("number", 0)),
                 {k: round(float(v), 4) for k, v in summary.items()})
        return summary

    def _log_audio_samples(self, step, batch_idx, mix, tgt, est):
        """Loudness-matched validation audio (reference universe.py:662-704)
        as WAVs under ``audio/`` in the run dir: the mix and target once, the
        enhanced clip at every validation."""
        num = self.model.val_kwargs.get("num_tb_samples", 0)
        if num <= 0 or batch_idx > 0:
            return
        from ..data.audio import save_audio
        from ..metrics.loudness import loudness

        fs = self.model.fs
        out = self.output_dir / "audio"
        out.mkdir(exist_ok=True)

        def matched(x, ref_loud):
            gain = 10.0 ** ((ref_loud - loudness(x, fs)) / 20.0)
            return x * gain if np.isfinite(gain) else x

        for idx in range(min(num, est.shape[0])):
            mix_i = mix[idx, :, 0]
            mix_loud = loudness(mix_i, fs)
            if not self._first_val_done:
                save_audio(out / f"mix_{idx}.wav",
                           mix_i * 0.95 / max(np.max(np.abs(mix_i)), 1e-9), fs)
                save_audio(out / f"target_{idx}.wav", matched(tgt[idx, 0], mix_loud), fs)
            save_audio(out / f"enh_{idx}_step_{step:08d}.wav",
                       matched(est[idx, 0], mix_loud), fs)
        self._first_val_done = True

    # ------------------------------------------------------------------
    def save(self, step: int) -> Path:
        """Write ``checkpoints/step_<step>.ckpt`` in the reference's layout,
        then last.json, index.json and best.json (rank 0; the other ranks
        gather their tp shards with it, then wait)."""
        path = self.output_dir / "checkpoints" / f"step_{step:08d}.ckpt"
        ckpt = self._checkpoint(step)
        if mesh.is_main():
            torch.save(ckpt, path)
            self._commit_last_json(step, path,
                                   self._last_val.get(self.model.val_kwargs.get("main_loss")))
            log.info("saved checkpoint %s", path)
        mesh.barrier()
        return path

    def _checkpoint(self, step: int) -> Optional[Dict[str, Any]]:
        """The checkpoint's content, every tensor whole (the tp ranks gather
        their shards together); None on a rank that writes nothing and
        holds no shard."""
        dims = tp.dims(self.model)
        if not (mesh.is_main() or dims):
            return None
        step_fn = self.step_fn
        pdims = tp.param_dims(self.model)
        sd = {self._ckpt_key(k): v.detach().cpu()
              for k, v in tp.gather_state(self.model.state_dict(), dims).items()}
        opts = optimizers(step_fn)
        ckpt: Dict[str, Any] = {
            "state_dict": sd, "global_step": step,
            "optimizer_states": [tp.gather_optimizer(o, pdims) for o, _, _ in opts],
            "lr_schedulers": [{"updates": getattr(step_fn, count),
                               "_last_lr": [g["lr"] for g in o.param_groups]}
                              for o, count, _ in opts]}
        if any(acc.k > 1 for _, _, acc in opts):
            ckpt["grad_accumulators"] = [self._accumulator_state(acc, tp.gather)
                                         for _, _, acc in opts]
        if self.ema is not None:
            names = ordered_param_names(sd, self.model.model_param_keys())
            shadow = tp.gather_state(self.ema.shadow, dims)
            ckpt["ema"] = {"shadow_params": [shadow[normalize_key(n)].cpu() for n in names],
                           "decay": self.ema.decay,
                           "num_updates": self.ema.num_updates}
        return ckpt

    def _accumulator_state(self, acc, fn, state=None) -> Dict[str, Any]:
        """An accumulator's state (``acc.state_dict()`` by default) with
        ``fn`` (``tp.gather`` or ``tp.local``) applied to the running means
        of sharded parameters."""
        state = dict(acc.state_dict() if state is None else state)
        pdims = tp.param_dims(self.model)
        if state["acc"] is not None and pdims:
            state["acc"] = [fn(a, pdims[id(p)]) if id(p) in pdims else a
                            for a, p in zip(state["acc"], acc.params)]
        return state

    def _ckpt_key(self, name: str) -> str:
        """A state_dict name as the reference's checkpoint writes it: a LoRA
        fine-tune's EDM score network is ``model._edm_model.``
        (``normalize_key`` maps it back)."""
        m = self.model
        if isinstance(m, EnhancementBaseModel) and getattr(m.model, "with_edm", False):
            return re.sub(r"^model\.score_model\.", "model._edm_model.", name)
        return name

    def _commit_last_json(self, step: int, path: Path, metric: Optional[float]):
        """last.json -> the newest checkpoint; index.json gains its entry
        with the newest validation's ``validation.main_loss`` (e.g.
        val/pesq; the reference encodes it in the checkpoint's file name,
        train.py:64-76); best.json -> the best entry by ``main_loss_mode``."""
        ckpt_dir = self.output_dir / "checkpoints"
        with open(ckpt_dir / "last.json", "w") as f:
            json.dump({"step": step, "path": str(path)}, f)
        main_name = self.model.val_kwargs.get("main_loss")
        index_path = ckpt_dir / "index.json"
        index = []
        if index_path.exists():
            with open(index_path) as f:
                index = json.load(f)
        index = [e for e in index if e["step"] != step]
        index.append({"step": step, "path": str(path), "metric": main_name,
                      "value": metric})
        with open(index_path, "w") as f:
            json.dump(index, f, indent=2)
        scored = [e for e in index if e.get("value") is not None]
        if scored:
            pick = max if self.model.val_kwargs.get("main_loss_mode", "min") == "max" else min
            with open(ckpt_dir / "best.json", "w") as f:
                json.dump(pick(scored, key=lambda e: e["value"]), f)

    def restore(self, path) -> int:
        """Load the model (loss modules included), the optimizers' states,
        their update counts and gradient accumulators, the EMA shadow and
        the step from a checkpoint ``save`` wrote: the ``.ckpt`` ``path``,
        or the one a checkpoints dir's (or a run dir's) ``last.json`` points
        at; returns the step."""
        p = Path(path)
        if p.is_dir() and not (p / "last.json").exists() \
                and (p / "checkpoints" / "last.json").exists():
            p = p / "checkpoints"
        if p.is_dir():
            with open(p / "last.json") as f:
                last = Path(json.load(f)["path"])
            p = last if last.exists() else p / last.name
        ckpt = torch.load(p, map_location=self.device, weights_only=False)
        dims, pdims = tp.dims(self.model), tp.param_dims(self.model)
        self.model.load_state_dict(tp.scatter_state(
            {normalize_key(k): v for k, v in ckpt["state_dict"].items()}, dims))
        step_fn = self.step_fn
        opts = optimizers(step_fn)
        if len(ckpt["optimizer_states"]) != len(opts):
            raise ValueError(f"{p} holds {len(ckpt['optimizer_states'])} optimizer "
                             f"states; this model's step has {len(opts)}")
        accs = ckpt.get("grad_accumulators") or [None] * len(opts)
        for (opt, count, acc), state, sch, acc_state in zip(
                opts, ckpt["optimizer_states"], ckpt["lr_schedulers"], accs):
            opt.load_state_dict(tp.scatter_optimizer(opt, state, pdims))
            setattr(step_fn, count, int(sch["updates"]))
            if acc_state is not None:
                acc.load_state_dict(self._accumulator_state(acc, tp.local, acc_state))
        if self.ema is not None:
            names = ordered_param_names(ckpt["state_dict"], self.model.model_param_keys())
            shadow = tp.scatter_state({normalize_key(n): s for n, s in
                                       zip(names, ckpt["ema"]["shadow_params"])}, dims)
            with torch.no_grad():
                for n, s in shadow.items():
                    self.ema.shadow[n].copy_(s)
            self.ema.num_updates = int(ckpt["ema"]["num_updates"])
        step_fn.step = int(ckpt["global_step"])
        log.info("restored checkpoint %s (step %d)", p, step_fn.step)
        return step_fn.step
