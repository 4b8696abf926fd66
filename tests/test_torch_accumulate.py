"""Gradient accumulation (``optimizer.accumulate_grad_batches``) in the
PyTorch port against the JAX package's steps wrapped in ``optax.MultiSteps``
as JAX's ``Trainer._setup`` wraps them, at float32 on the CPU: k = 2 over 4
micro-batches (2 updates) for the UNIVERSE++ GAN step (the discriminators
frozen for the first micro-batch: ``disc_freeze_step`` counts
micro-batches, so their accumulator starts a call later and emits at the
third), the plain UNIVERSE's single-optimizer step and the LoRA step; and a
resume from a checkpoint taken mid-accumulation.

Each JAX step is compiled once for the module, on narrow models (2-level
U-Nets); the draws are JAX's, handed to the port.  Bounds: every parameter
and EMA shadow within 1e-5 of its tensor's largest value, save elements
whose accumulated gradient is below 1e-2 of its tensor's largest or below
1e-7 (AdamW moves such an element by about +-lr whatever its gradient's
size, so float32's rounding can flip it, as ``test_torch_train._check_deltas``
says): those are counted, held to 2 lr per update and to 1e-2 of the
elements; the learning rate of every update as JAX's schedule gives it; the
update counts and each accumulator's position as ``MultiSteps``' state.
"""
import copy

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from open_universe_tpu.configs import registry as jregistry  # noqa: E402
from open_universe_tpu.nn.module import buffer_mask  # noqa: E402
from open_universe_tpu.train import optim as joptim  # noqa: E402
from open_universe_tpu.train.steps import (  # noqa: E402
    init_train_state,
    make_gan_train_step,
    make_train_step,
)
from open_universe_tpu.train.trainer import _build_schedule  # noqa: E402
from open_universe_tpu_torch.configs import registry as pregistry  # noqa: E402
from open_universe_tpu_torch.train import trainer as ptrainer  # noqa: E402
from open_universe_tpu_torch.utils.convert import from_jax_params  # noqa: E402
from test_checkpoint_conversion import TINY_GAN_CFG  # noqa: E402
from test_torch_lora import (  # noqa: E402
    PAD_SHAPE,
    _jax_lora,
    _port_base,
    _port_lora,
    lora_draws,
)
from test_torch_train import (  # noqa: E402
    MAX_STEPS,
    _flat,
    _port_layout,
    draw_params,
    gan_config,
    step_draws,
)
from test_torch_universe_original import config as orig_config  # noqa: E402
from test_torch_universe_original import loss_draws, torch_draws  # noqa: E402

K, CALLS, B, T = 2, 4, 2, 800
LR = 2e-4
LORA_LR = 1e-5  # universe_lora.yaml's


def batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(CALLS):
        clean = (rng.standard_normal((B, T, 1)) * 0.05).astype(np.float32)
        out.append({"clean": clean,
                    "noisy": clean + (rng.standard_normal((B, T, 1)) * 0.02).astype(np.float32)})
    return out


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def narrow_gan_config():
    """test_torch_train's config with 2-level U-Nets, one MPD period, the
    discriminators frozen for one micro-batch, k = 2."""
    cfg = gan_config()
    for k in ("score_model", "condition_model"):
        cfg[k]["rate_factors"] = [2, 4]
    cfg["losses"]["multi_period_discriminator"]["mpd_reshapes"] = [2]
    cfg["losses"]["disc_freeze_step"] = 1
    cfg["optimizer"]["accumulate_grad_batches"] = K
    return cfg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):  # numpy's BLAS too
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gan_run():
    """JAX's GAN step with both optimizers in MultiSteps(k=2), jitted once,
    over 4 micro-batches; the state after each call."""
    cfg = narrow_gan_config()
    jm = jregistry.instantiate(cfg)
    params = np_tree(draw_params(jm, seed=3))
    gen_keys = list(jm.model_param_keys())
    mask = buffer_mask(jm, params)
    gen_mask = {k: mask[k] if k in set(jm.optimized_param_keys())
                else jax.tree_util.tree_map(lambda _: False, mask[k]) for k in gen_keys}
    sch = cfg["scheduler"]
    sched_g = _build_schedule(sch["generator"], LR, MAX_STEPS, gan_role="generator",
                              freeze_step=1)
    sched_d = _build_schedule(sch["discriminator"], LR, MAX_STEPS,
                              gan_role="discriminator", freeze_step=1)
    tx = optax.MultiSteps(joptim.adamw(
        sched_g, betas=(0.8, 0.99), weight_decay=0.01, weight_decay_exclude=("prelu", "bias"),
        params={k: params[k] for k in gen_keys}, trainable_mask=gen_mask), every_k_schedule=K)
    tx_d = optax.MultiSteps(joptim.adamw(sched_d, betas=(0.8, 0.99), weight_decay=0.01),
                            every_k_schedule=K)
    step = jax.jit(make_gan_train_step(jm, tx, tx_d,
                                       grad_clip_vals=cfg["optimizer"]["grad_clip_vals"]))
    states = [init_train_state(jm, params, tx, disc_tx=tx_d)]
    keys = [jax.random.key(30 + i) for i in range(CALLS)]
    data = batches(8)
    for key, batch in zip(keys, data):
        states.append(step(states[-1], batch, key)[0])
    return dict(cfg=cfg, params=params, batches=data, draws=[step_draws(k) for k in keys],
                states=[np_tree(s) for s in states], sched=(sched_g, sched_d))


def _port_gan(run):
    model = pregistry.instantiate_trainable(copy.deepcopy(run["cfg"]))
    assert from_jax_params(model, run["params"]) == []
    return model, ptrainer.make_gan_step(model, MAX_STEPS)


def _gan_call(step, run, i):
    batch = {k: torch.from_numpy(v) for k, v in run["batches"][i].items()}
    return step(batch, draws={k: torch.from_numpy(v.copy()) for k, v in run["draws"][i].items()})


def check_against(model, want_params, want_ema, grads, ema, lr_sum, record_property, tag):
    """Every parameter (and EMA shadow) of ``model`` against JAX's (port
    layout) within 1e-5 of the tensor's largest value; elements whose
    accumulated gradient is small are counted and held to 2 lr per update.
    Returns the count."""
    small, n_el = 0, 0
    for name, p in model.named_parameters():
        if name not in want_params:
            continue
        pairs = [(p.detach().numpy(), want_params[name])]
        if ema is not None and name in want_ema:
            pairs.append((ema.shadow[name].numpy(), want_ema[name]))
        g = grads.get(name)
        for got, want in pairs:
            diff = np.abs(got - want)
            bad = diff > 1e-5 * np.abs(want).max()
            if g is None:
                assert not bad.any(), (tag, name, diff.max())
                continue
            tiny = (np.abs(g) < 1e-2 * np.abs(g).max()) | (np.abs(g) < 1e-7)
            assert not (bad & ~tiny).any(), (tag, name, diff.max(), np.abs(want).max())
            assert (diff[bad] <= 2 * lr_sum).all(), (tag, name, diff.max())
            small += int(bad.sum())
            n_el += got.size
    record_property(f"{tag}_small_gradient_elements_over_bound", small)
    assert small <= 1e-2 * n_el, (tag, small, n_el)
    return small


def test_gan_step_accumulates_as_multisteps(gan_run, record_property):
    """Calls 0-3: the generator updates at calls 1 and 3 on the mean of two
    clipped micro-batch gradients; the discriminators are frozen at call 0
    (disc_freeze_step 1 counts calls), accumulate calls 1-2 and update at 2;
    EMA moves every call.  Parameters and EMA after calls 1, 2 and 3 against
    JAX; learning rates and update counts as JAX's schedules and
    MultiSteps' state."""
    run = gan_run
    model, step = _port_gan(run)
    sched_g, sched_d = run["sched"]
    lrs, acc_grads = [], {}
    for i in range(CALLS):
        _gan_call(step, run, i)
        lrs.append((step.opt_gen.param_groups[0]["lr"], step.opt_disc.param_groups[0]["lr"]))
        if i in (1, 3):  # the generator's update: .grad holds the accumulated mean
            acc_grads.update({n: p.grad.numpy().copy() for n, p in model.named_parameters()
                              if not n.startswith("loss_m")})
        if i == 2:
            acc_grads.update({n: p.grad.numpy().copy() for n, p in model.named_parameters()
                              if n.startswith("loss_m")})
        if i >= 1:
            st = run["states"][i + 1]
            check_against(model, _port_layout(model, _flat(st["params"])),
                          _port_layout(model, _flat(st["ema"]["shadow"])),
                          acc_grads, step.ema, 2 * LR, record_property, f"call{i}")
        jg, jd = run["states"][i + 1]["opt_state"], run["states"][i + 1]["disc_opt_state"]
        assert (step.gen_updates, step.gen_accum.mini_step) == (int(jg.gradient_step),
                                                                int(jg.mini_step)), i
        assert (step.disc_updates, step.disc_accum.mini_step) == (int(jd.gradient_step),
                                                                  int(jd.mini_step)), i
    assert (step.step, step.gen_updates, step.disc_updates, step.ema.num_updates) == (4, 2, 1, 4)
    np.testing.assert_allclose([lr[0] for lr in lrs], [0.0, float(sched_g(0)), float(sched_g(0)),
                                                      float(sched_g(1))], rtol=1e-6)
    np.testing.assert_allclose(lrs[2][1], float(sched_d(0)), rtol=1e-6)
    # the discriminators did not move before their update at call 2
    p0 = _port_layout(model, _flat(run["params"]))
    mid = _port_layout(model, _flat(run["states"][2]["params"]))
    for n in p0:
        if n.startswith("loss_m"):
            np.testing.assert_array_equal(mid[n], p0[n])


def test_gan_resume_mid_accumulation(gan_run, tmp_path):
    """A checkpoint after call 2 (the generator's accumulator half full)
    written by ``Trainer.save`` and read by ``Trainer.restore`` into a fresh
    model: call 3 then gives the uninterrupted run's state bit for bit."""
    run = gan_run
    model, step = _port_gan(run)
    for i in range(3):
        _gan_call(step, run, i)
    assert step.gen_accum.mini_step == 1 and step.gen_accum.acc is not None
    tr = _bare_trainer(model, step, tmp_path)
    path = tr.save(3)
    _gan_call(step, run, 3)

    model2, step2 = _port_gan(run)
    tr2 = _bare_trainer(model2, step2, tmp_path)
    assert tr2.restore(path) == 3
    assert step2.gen_accum.mini_step == 1
    _gan_call(step2, run, 3)
    for (n, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(a, b), n
    for n, s in step.ema.shadow.items():
        assert torch.equal(s, step2.ema.shadow[n]), n
    assert (step2.gen_updates, step2.disc_updates, step2.disc_accum.mini_step) == (2, 1, 1)


def _bare_trainer(model, step, out):
    """A Trainer around a built step, for save and restore only."""
    tr = ptrainer.Trainer.__new__(ptrainer.Trainer)
    tr.__dict__.update(model=model, step_fn=step, ema=step.ema, output_dir=out,
                       _last_val={}, device=torch.device("cpu"))
    (out / "checkpoints").mkdir(exist_ok=True)
    return tr


# ------------------------------------------------- the single-optimizer step
@pytest.fixture(scope="module")
def orig_run():
    """JAX's make_train_step for the plain UNIVERSE (AdamW with the
    experiment's decay, its warm-up schedule, the FixedClipper) in
    MultiSteps(k=2), jitted once, over 4 micro-batches."""
    jcfg, pcfg = orig_config(f"+model.optimizer.accumulate_grad_batches={K}")
    jm = jregistry.instantiate(jcfg)
    params = np_tree(draw_params(jm, seed=7))
    opt = jcfg["optimizer"]
    sched = _build_schedule(jcfg["scheduler"], opt["lr"], MAX_STEPS)
    tx = optax.MultiSteps(joptim.adamw(
        sched, betas=tuple(opt["betas"]), weight_decay=opt["weight_decay"],
        weight_decay_exclude=opt["weight_decay_exclude"], params=params,
        trainable_mask=buffer_mask(jm, params)), every_k_schedule=K)
    clipper = joptim.make_clipper({"max_norm": jcfg["grad_clipper"]["max_norm"]})
    step = jax.jit(make_train_step(jm, tx, clipper=clipper))
    states = [init_train_state(jm, params, tx, clipper=clipper)]
    keys = [jax.random.key(40 + i) for i in range(CALLS)]
    data = batches(9)
    for key, batch in zip(keys, data):
        states.append(step(states[-1], batch, key)[0])
    return dict(pcfg=pcfg, params=params, batches=data, draws=[loss_draws(k) for k in keys],
                states=[np_tree(s) for s in states], sched=sched, lr=opt["lr"])


def test_single_optimizer_step_accumulates_as_multisteps(orig_run, record_property):
    """The plain UNIVERSE's TrainStep with k = 2: updates at calls 1 and 3
    (every parameter, the MDN loss modules' included), EMA every call;
    parameters and EMA after calls 1 and 3, the learning rates, the counts
    and the accumulator against JAX."""
    run = orig_run
    model = pregistry.instantiate_trainable(copy.deepcopy(run["pcfg"]))
    assert from_jax_params(model, run["params"]) == []
    step = ptrainer.make_step(model, MAX_STEPS)
    lrs = []
    for i in range(CALLS):
        step({k: torch.from_numpy(v) for k, v in run["batches"][i].items()},
             draws=torch_draws(run["draws"][i]))
        lrs.append(step.opt.param_groups[0]["lr"])
        st = run["states"][i + 1]
        assert (step.updates, step.accum.mini_step) == (int(st["opt_state"].gradient_step),
                                                        int(st["opt_state"].mini_step)), i
        if i in (1, 3):
            grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
            check_against(model, _port_layout(model, _flat(st["params"])),
                          _port_layout(model, _flat(st["ema"]["shadow"])), grads,
                          step.ema, 2 * run["lr"], record_property, f"call{i}")
    np.testing.assert_allclose(lrs, [0.0, float(run["sched"](0)), float(run["sched"](0)),
                                     float(run["sched"](1))], rtol=1e-6)
    assert (step.step, step.updates, step.ema.num_updates) == (4, 2, 4)


# ---------------------------------------------------------------- LoRA
@pytest.fixture(scope="module")
def lora_run():
    """JAX's LoRA step (n_steps_backprop 1, the multi-resolution loss) as
    JAX's trainer builds it, its AdamW in MultiSteps(k=2), jitted once, over
    4 micro-batches."""
    base = _port_base()
    kw = dict(use_hifigan_loss=False,
              optimizer={"lr": LORA_LR, "weight_decay": 1e-4, "accumulate_grad_batches": K})
    pl = _port_lora(base, 1, **kw)
    jm = jregistry.instantiate(copy.deepcopy(TINY_GAN_CFG))
    jl, jp = _jax_lora(jm, pl, 1, **kw)
    mask = jax.tree_util.tree_map(lambda a, b: bool(a) and bool(b), buffer_mask(jl, jp),
                                  jl.trainable_mask(jp))
    tx = optax.MultiSteps(joptim.adamw(
        LORA_LR, betas=(0.8, 0.99), weight_decay=1e-4, weight_decay_exclude=("prelu", "bias"),
        params=jp, trainable_mask=mask), every_k_schedule=K)
    clipper = joptim.FixedClipper(1000.0)
    step = jax.jit(make_train_step(jl, tx, clipper=clipper))
    states = [init_train_state(jl, jp, tx, clipper=clipper)]
    keys = [jax.random.key(50 + i) for i in range(CALLS)]
    data = batches(10)
    for key, batch in zip(keys, data):
        states.append(step(states[-1], {k: jnp.asarray(v) for k, v in batch.items()}, key)[0])
    return dict(pl=pl, batches=data, keys=keys, states=[np_tree(s) for s in states])


def test_lora_step_accumulates_as_multisteps(lora_run, record_property):
    """The LoRA TrainStep with k = 2 (the trainable set: adapters and
    biases): the frozen weights stay bit for bit; the trainable ones and
    their EMA after calls 1 and 3 against JAX."""
    run = lora_run
    pl = run["pl"]
    frozen = {n: p.detach().clone() for n, p in pl.named_parameters() if not p.requires_grad}
    step = ptrainer.make_train_step(pl, 100)
    for i in range(CALLS):
        k_fwd, _ = jax.random.split(run["keys"][i])
        step({k: torch.from_numpy(v) for k, v in run["batches"][i].items()},
             draws={"noise": lora_draws(k_fwd, PAD_SHAPE)})
        st = run["states"][i + 1]
        assert (step.updates, step.accum.mini_step) == (int(st["opt_state"].gradient_step),
                                                        int(st["opt_state"].mini_step)), i
        if i in (1, 3):
            grads = {n: p.grad.numpy().copy() for n, p in pl.named_parameters()
                     if p.requires_grad}
            want = {n: v for n, v in _flat(st["params"]).items() if n in grads}
            shadow = {n: v for n, v in _flat(st["ema"]["shadow"]).items() if n in grads}
            assert want
            check_against(pl, want, shadow, grads, step.ema, 2 * LORA_LR, record_property,
                          f"lora_call{i}")
    for n, p in pl.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p.detach(), frozen[n]), n
    assert (step.step, step.updates) == (4, 2)
