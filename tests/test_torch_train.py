"""UNIVERSE++ training in the PyTorch port against the JAX package, at float32
on the CPU: the discriminators, time sampling, the GAN losses, one GAN
step's gradients, two full steps with EMA (``make_gan_train_step``), the
optimizers, schedules and clipping against optax, the disc-frozen and
nan-guarded steps, config composition, the data loader, and the training
entry point end to end through a checkpoint ``load_model`` reads.

Weights are drawn with numpy into the JAX param tree and carried over with
``from_jax_params``; the random draws of a step (sigma's uniform draws, the
score's noise) are JAX's, handed to the port.  The JAX step is compiled
once for the module.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from open_universe_tpu.configs import registry as jregistry  # noqa: E402
from open_universe_tpu.configs.resolve import compose as jax_compose  # noqa: E402
from open_universe_tpu.data import dataset as jdataset  # noqa: E402
from open_universe_tpu.models import discriminators as jdisc  # noqa: E402
from open_universe_tpu.nn.module import buffer_mask  # noqa: E402
from open_universe_tpu.train import optim as joptim  # noqa: E402
from open_universe_tpu.train.ema import ema_init, ema_update  # noqa: E402
from open_universe_tpu.train.steps import init_train_state, make_gan_train_step  # noqa: E402
from open_universe_tpu.train.trainer import _build_schedule  # noqa: E402
from open_universe_tpu_torch.configs import registry as pregistry  # noqa: E402
from open_universe_tpu_torch.configs.resolve import compose as port_compose  # noqa: E402
from open_universe_tpu_torch.data import dataset as pdataset  # noqa: E402
from open_universe_tpu_torch.models import discriminators as pdisc  # noqa: E402
from open_universe_tpu_torch.train import optim as poptim  # noqa: E402
from open_universe_tpu_torch.train.ema import EMA  # noqa: E402
from open_universe_tpu_torch.train.trainer import make_gan_step  # noqa: E402
from open_universe_tpu_torch.utils.convert import from_jax_params  # noqa: E402
from open_universe_tpu_torch.utils.random import center_truncated_normal  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FS, T, B = 16000, 800, 2
MAX_STEPS = 300000
_NET = "open_universe.networks.universe."
_SCORE = dict(fb_kernel_size=3, rate_factors=[2, 4, 4, 5], n_channels=4, n_rff=32,
              noise_cond_dim=32, encoder_gru_conv_sandwich=False, extra_conv_block=True,
              decoder_act_type="prelu", use_weight_norm=True, use_antialiasing=True,
              time_embedding="simple")
_COND = dict(fb_kernel_size=3, rate_factors=[2, 4, 4, 5], n_channels=4, n_mels=16,
             n_mel_oversample=4, encoder_gru_residual=True, extra_conv_block=True,
             decoder_act_type="prelu", use_weight_norm=True, use_antialiasing=False)
_DISC = {"multi_period_discriminator": {"mpd_reshapes": [2, 3], "use_spectral_norm": False,
                                        "discriminator_channel_mult": 0.25},
         "multi_resolution_discriminator": {
             "resolutions": [[128, 30, 75], [256, 60, 150], [64, 12, 30]],
             "use_spectral_norm": False, "discriminator_channel_mult": 0.25}}
# T_warmup 2: the updates are lr/2 and lr, not ~lr/20000
_SCHED = {"scheduler": {"_target_": "open_universe_tpu.train.optim."
                                    "LinearWarmupCosineAnnealingLR",
                        "T_warmup": 2, "T_cosine": 400000, "eta_min": 1.6e-6,
                        "T_max": MAX_STEPS}}


def gan_config(**training):
    return {
        "_target_": _NET + "UniverseGAN", "fs": FS, "normalization_norm": 2,
        "normalization_kwargs": {"ref": "both", "level_db": -26.0}, "edm": {"noise": 0.25},
        "score_model": {"_target_": _NET + "ScoreNetwork", **_SCORE},
        "condition_model": {"_target_": _NET + "ConditionerNetwork", **_COND},
        "diffusion": {"schedule": "geometric", "sigma_min": 0.0005, "sigma_max": 5.0,
                      "n_steps": 8, "epsilon": 1.3},
        "losses": {**_DISC, "disc_freeze_step": 0, "weights": {"mel_l1": 45.0, "score": 1.0},
                   "use_signal_decoupling": True, "signal_decoupling_act": "snake",
                   "score_loss": {"_target_": "torch.nn.MSELoss"}},
        "training": {"audio_len": T / FS, "time_sampling": "time_normal_0.95",
                     "dynamic_mixing": False, "ema_decay": 0.999, **training},
        "optimizer": {"generator": {"lr": 2e-4, "weight_decay": 0.01, "betas": [0.8, 0.99],
                                    "weight_decay_exclude": ["prelu", "bias"]},
                      "discriminator": {"lr": 2e-4, "betas": [0.8, 0.99]},
                      "grad_clip_vals": {"mrd": 1000.0, "mpd": 1000.0, "score": 1000.0,
                                         "cond": 1000.0}},
        "scheduler": {"generator": _SCHED, "discriminator": _SCHED},
    }


def draw_params(jax_mod, seed=0):
    """A param tree of ``jax_mod``'s structure drawn with numpy (uniform,
    scaled by 1/sqrt(fan_in) for matrices and kernels)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_mod.init, jax.random.key(0))

    def draw(s):
        scale = 1.0 / np.sqrt(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 0.5
        return (rng.uniform(-1.0, 1.0, s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def port_pair(params, **training):
    """The port's model of ``gan_config(**training)`` with ``params``."""
    model = pregistry.instantiate_trainable(gan_config(**training))
    assert from_jax_params(model, params) == []
    return model


def step_draws(key):
    """make_gan_train_step's draws for ``key``: (u for sigma, z)."""
    _, k_fwd = jax.random.split(key)
    k_sigma, k_noise = jax.random.split(k_fwd)
    return {"u": np.asarray(jax.random.uniform(k_sigma, (B,))),
            "z": np.asarray(jax.random.normal(k_noise, (B, T, 1)))}


def _capture():
    """A transform that keeps the gradients it is given as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, state, params=None: (g, g))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _port_layout(model, flat):
    """JAX leaves in the port's layout, by the port's parameter names."""
    from open_universe_tpu_torch.utils.convert import _to_port_layout

    modules, state = dict(model.named_modules()), model.state_dict()
    out = {}
    for name, v in flat.items():
        if name in state:
            mod_path, _, leaf = name.rpartition(".")
            out[name] = _to_port_layout(modules[mod_path], leaf, v)
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's steps at these sizes are launch-bound: one intra-op thread
    keeps them from oversubscribing the cores the other test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):  # numpy's BLAS too
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gan_run():
    """Two steps of JAX's make_gan_train_step, jitted once, from numpy
    weights; the captured gradients of step 1 (before clipping: the norms
    stay under the clip values) and each step's draws and metrics."""
    cfg = gan_config()
    jm = jregistry.instantiate(cfg)
    params = draw_params(jm)
    mask = buffer_mask(jm, params)
    gen_keys = list(jm.model_param_keys())
    optimized = set(jm.optimized_param_keys())
    gen_mask = {k: mask[k] if k in optimized else jax.tree_util.tree_map(lambda _: False, mask[k])
                for k in gen_keys}
    sch = cfg["scheduler"]
    tx = optax.chain(_capture(), joptim.adamw(
        _build_schedule(sch["generator"], 2e-4, MAX_STEPS, gan_role="generator"),
        betas=(0.8, 0.99), weight_decay=0.01, weight_decay_exclude=("prelu", "bias"),
        params={k: params[k] for k in gen_keys}, trainable_mask=gen_mask))
    tx_disc = optax.chain(_capture(), joptim.adamw(
        _build_schedule(sch["discriminator"], 2e-4, MAX_STEPS, gan_role="discriminator"),
        betas=(0.8, 0.99), weight_decay=0.01))
    # one compiled init, not ~2600 eagerly compiled ops
    state0 = jax.jit(lambda p: init_train_state(jm, p, tx, disc_tx=tx_disc))(params)
    step = jax.jit(make_gan_train_step(jm, tx, tx_disc,
                                       grad_clip_vals=cfg["optimizer"]["grad_clip_vals"]))
    rng = np.random.default_rng(1)
    clean = (rng.standard_normal((B, T, 1)) * 0.05).astype(np.float32)
    batch = {"clean": clean,
             "noisy": clean + (rng.standard_normal((B, T, 1)) * 0.02).astype(np.float32)}
    keys = [jax.random.key(10), jax.random.key(11)]
    states, metrics = [state0], []
    for key in keys:
        st, m = step(states[-1], batch, key)
        states.append(st)
        metrics.append({k: float(v) for k, v in m.items()})
    grads = {**_flat(states[1]["opt_state"][0]), **_flat(states[1]["disc_opt_state"][0])}
    return dict(params=jax.tree_util.tree_map(np.asarray, params), batch=batch,
                draws=[step_draws(k) for k in keys], metrics=metrics,
                grads=grads, states=[jax.tree_util.tree_map(np.asarray, s) for s in states])


def _port_steps(run, n):
    model = port_pair(run["params"])
    step = make_gan_step(model, MAX_STEPS)
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    metrics = []
    for i in range(n):
        metrics.append({k: float(v) for k, v in step(batch, draws={
            k: torch.from_numpy(v.copy()) for k, v in run["draws"][i].items()}).items()})
    return model, step, metrics


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


# ------------------------------------------------------------ discriminators
def test_discriminators_match_jax(rng):
    """DiscriminatorP (a length that is no multiple of the period: reflect
    pad) and DiscriminatorR (rectangular-window STFT), then MPD and MRD:
    scores and every feature map <= 1e-5 x max|ref|; the paired 2B pass
    equals separate passes."""
    cfg = {"discriminator_channel_mult": 0.25}
    y = (rng.standard_normal((2, 301, 1)) * 0.1).astype(np.float32)
    y_hat = (rng.standard_normal((2, 301, 1)) * 0.1).astype(np.float32)
    for jd, pd in ((jdisc.DiscriminatorP(cfg, 3), pdisc.DiscriminatorP(cfg, 3)),
                   (jdisc.DiscriminatorR(cfg, [128, 30, 75]),
                    pdisc.DiscriminatorR(cfg, [128, 30, 75]))):
        params = draw_params(jd)
        assert from_jax_params(pd, params) == []
        s_j, f_j = jax.jit(jd.apply)(params, jnp.asarray(y))
        with torch.no_grad():
            s_p, f_p = pd(torch.from_numpy(y))
            s_r, s_g, f_r, f_g = pdisc.paired_apply(pd, torch.from_numpy(y),
                                                    torch.from_numpy(y_hat))
            s_g2, f_g2 = pd(torch.from_numpy(y_hat))
        _close_scaled(s_p, s_j)
        assert len(f_p) == len(f_j) == 6
        for a, b in zip(f_p, f_j):
            _close_scaled(a.permute(0, 2, 3, 1), b)
        torch.testing.assert_close(s_r, s_p, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(s_g, s_g2, rtol=1e-6, atol=1e-6)
        for a, b in zip(f_r + f_g, f_p + f_g2):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for jcls, pcls, sub in ((jdisc.MultiPeriodDiscriminator, pdisc.MultiPeriodDiscriminator,
                             "multi_period_discriminator"),
                            (jdisc.MultiResolutionDiscriminator,
                             pdisc.MultiResolutionDiscriminator,
                             "multi_resolution_discriminator")):
        jd, pd = jcls(_DISC[sub]), pcls(_DISC[sub])
        params = draw_params(jd, seed=3)
        assert from_jax_params(pd, params) == []
        out_j = jax.jit(jd.apply)(params, jnp.asarray(y), jnp.asarray(y_hat))
        with torch.no_grad():
            out_p = pd(torch.from_numpy(y), torch.from_numpy(y_hat))
        for scores_p, scores_j in zip(out_p[:2], out_j[:2]):
            for a, b in zip(scores_p, scores_j):
                _close_scaled(a, b)
        for fmaps_p, fmaps_j in zip(out_p[2:], out_j[2:]):
            for fp, fj in zip(fmaps_p, fmaps_j):
                for a, b in zip(fp, fj):
                    _close_scaled(a.permute(0, 2, 3, 1), b)


def _close_scaled(a, b, tol=1e-5):
    a, b = np.asarray(a.detach() if torch.is_tensor(a) else a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=tol * np.abs(b).max(), rtol=0)


# ------------------------------------------------------------ time sampling
@pytest.mark.parametrize("mode", ["time_uniform", "sigma_linear", "diffsym",
                                  "time_discrete", "time_normal_0.95", "time_normal_0.8",
                                  "adaptive"])
def test_sample_sigma_matches_jax(mode, record_property):
    """Every mode maps JAX's uniform draws to JAX's (sigma, time): time
    within 1e-6; sigma within 2e-6 relative, since sigma = sigma_min
    (sigma_max / sigma_min)^time turns one float32 ulp of time (6e-8 below
    1) into 9.2 ulp-widths of sigma (ln 1e4 = 9.2)."""
    jm = jregistry.instantiate(gan_config(time_sampling=mode))
    pm = pregistry.instantiate(gan_config(time_sampling=mode))
    key = jax.random.key(5)
    n = 512
    sigma_j, time_j = jax.jit(lambda k: jm.sample_sigma(k, n, mode, 0.1, 0.9))(key)
    u = np.asarray(jax.random.uniform(key, (n,)))
    sigma_p, time_p = pm.sample_sigma(n, mode, 0.1, 0.9, u=torch.from_numpy(u.copy()))
    np.testing.assert_allclose(time_p.numpy(), np.asarray(time_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sigma_p.numpy(), np.asarray(sigma_j), rtol=2e-6, atol=0)
    record_property("time_max_abs", float(np.abs(time_p.numpy() - np.asarray(time_j)).max()))
    record_property("sigma_max_rel", float(np.max(np.abs(sigma_p.numpy() - np.asarray(sigma_j))
                                                  / np.asarray(sigma_j))))
    if mode.startswith("time_normal"):
        from open_universe_tpu.utils import center_truncated_normal as jctn

        area = float(mode.split("_")[2])
        ref = jctn(key, area=area, minval=0.1, maxval=0.9, shape=(n,))
        np.testing.assert_allclose(
            center_truncated_normal(torch.from_numpy(u.copy()), area, 0.1, 0.9).numpy(),
            np.asarray(ref), atol=1e-6, rtol=0)


# ------------------------------------------------------------ the GAN step
def test_gan_losses_match_jax(gan_run, record_property):
    """Step 1 and 2's losses and every term of the metrics, given JAX's
    sigma and z: the discriminators' loss at the weights before the step,
    the generator's against the updated discriminators; relative <= 1e-5."""
    _, _, metrics = _port_steps(gan_run, 2)
    worst = 0.0
    for got, want in zip(metrics, gan_run["metrics"]):
        assert set(got) == set(want)
        for k in want:
            if k.startswith("train/"):
                assert _rel(got[k], want[k]) <= 1e-5 or abs(got[k] - want[k]) <= 1e-9, (
                    k, got[k], want[k])
                if want[k]:
                    worst = max(worst, _rel(got[k], want[k]))
    record_property("losses_max_rel", worst)


def test_gan_step_gradients_match_jax(gan_run, record_property):
    """Step 1's gradients of every tensor, before clipping (every group's
    norm is under its clip value, so clipping leaves them as they are):
    the discriminators' at their weights before the step, the generator's
    against the updated discriminators; max|d| <= 1e-4 x max|g_jax| per
    tensor, signal-decoupling layer included.  Exception: a shared PReLU
    slope's gradient is one sum over the whole batch, and where it cancels
    (|g| ~1e-10) float32's summation order shows; at most two such scalars
    may exceed the bound, each within 1e-3 of its value, and their count is
    recorded."""
    model, _, metrics = _port_steps(gan_run, 1)
    for k in ("grad/score", "grad/cond", "grad/mpd", "grad/mrd"):
        assert gan_run["metrics"][0][k] < 1000.0
        assert _rel(metrics[0][k], gan_run["metrics"][0][k]) <= 1e-5, k
    want = _port_layout(model, gan_run["grads"])
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    over, rel = [], []
    for name, g_j in want.items():
        g_p = params[name].grad
        assert g_p is not None, name
        scale = np.abs(g_j).max()
        assert scale > 0, name
        err = np.abs(g_p.numpy() - g_j).max()
        rel.append(float(err / scale))
        if err > 1e-4 * scale:
            assert name.endswith("prelu.weight") and g_j.size == 1, (name, err, scale)
            assert err <= 1e-3 * scale, (name, err, scale)
            over.append(name)
    record_property("scalar_slopes_over_1e-4",
                    {n: rel[list(want).index(n)] for n in over})
    record_property("grad_rel_median", float(np.median(rel)))
    record_property("grad_rel_max_other", max(r for r, n in zip(rel, want) if n not in over))
    assert len(over) <= 2, over


def _check_deltas(name, p0, d_port, d_jax, g1, lr):
    """Per tensor max|d_port - d_jax| <= 1e-3 max|d_jax|, plus the float32
    spacing of the parameter at each of the two steps (a change is the
    difference of two rounded parameters).  Exception: AdamW divides by
    sqrt(v) + 1e-8, so an element's update is about +-lr whatever its
    gradient's size, and where the gradient is small its relative error is
    large (the gradient bound is 1e-4 of the tensor's largest): elements
    whose first-step gradient is below 1e-2 of the tensor's largest or below
    1e-7 (ten times Adam's epsilon) are counted and held to 2 lr.  Returns
    their count and the largest difference elsewhere over max|d_jax|."""
    bound = 1e-3 * np.abs(d_jax).max() + 2 * np.spacing(np.abs(p0) + np.abs(d_jax))
    diff = np.abs(d_port - d_jax)
    bad = diff > bound
    tiny = (np.abs(g1) < 1e-2 * np.abs(g1).max()) | (np.abs(g1) < 1e-7)
    assert not (bad & ~tiny).any(), (name, diff.max(), bound.max())
    assert (diff[bad] <= 2 * lr).all(), (name, diff.max(), lr)
    return int(bad.sum()), float((diff * ~tiny).max() / np.abs(d_jax).max())


def test_two_gan_steps_match_jax(gan_run, record_property):
    """Two full steps of the port against make_gan_train_step: every
    parameter's change and every EMA shadow's, per tensor (see
    ``_check_deltas``); the signal-decoupling layer does not move."""
    model, step, _ = _port_steps(gan_run, 2)
    assert (step.step, step.gen_updates, step.disc_updates) == (2, 2, 2)
    p0 = _port_layout(model, _flat(gan_run["params"]))
    p2 = _port_layout(model, _flat(gan_run["states"][2]["params"]))
    e2 = _port_layout(model, _flat(gan_run["states"][2]["ema"]["shadow"]))
    g1 = _port_layout(model, gan_run["grads"])
    lr = 2e-4
    flips, worst = 0, 0.0
    for name, p in model.named_parameters():
        d_port, d_jax = p.detach().numpy() - p0[name], p2[name] - p0[name]
        if name.startswith("signal_decoupling_layer."):
            assert not d_port.any() and not d_jax.any(), name
            continue
        assert np.abs(d_jax).max() > 0, name
        n_small, rel = _check_deltas(name, p0[name], d_port, d_jax, g1[name], lr)
        flips, worst = flips + n_small, max(worst, rel)
        if name in e2:
            s = step.ema.shadow[name].numpy()
            n_small, rel = _check_deltas(name + " (EMA)", p0[name], s - p0[name],
                                         e2[name] - p0[name], g1[name], lr)
            flips, worst = flips + n_small, max(worst, rel)
    assert step.ema.num_updates == 2
    import copy

    evaluated = copy.deepcopy(model)
    step.ema.apply_to(evaluated)  # JAX's ema_apply: the shadows as weights
    for name, p in evaluated.named_parameters():
        want = step.ema.shadow.get(name, dict(model.named_parameters())[name])
        torch.testing.assert_close(p, want, rtol=0, atol=0)
    n = sum(p.numel() for p in model.parameters())
    record_property("small_gradient_elements_over_bound", flips)
    record_property("elements", n)
    record_property("worst_rel_delta", float(worst))
    assert flips <= 1e-3 * n, (flips, n)


def test_disc_frozen_step_and_nan_guard(gan_run):
    """Before disc_freeze_step the full step leaves the discriminators and
    their optimizer alone and drops the adversarial terms: the disc-frozen
    step, which runs no discriminator, updates the generator the same.  A
    step on a non-finite batch with nan_guard on rolls back the parameters,
    both optimizers and EMA, and the step count moves on."""
    run = gan_run
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    draws = {k: torch.from_numpy(v.copy()) for k, v in run["draws"][0].items()}
    after = []
    for frozen in (False, True):
        cfg = gan_config()
        cfg["losses"]["disc_freeze_step"] = 5
        model = pregistry.instantiate_trainable(cfg)
        from_jax_params(model, run["params"])
        step = make_gan_step(model, MAX_STEPS)
        m = step(batch, draws=draws, disc_frozen=frozen)
        assert step.disc_updates == 0 and step.gen_updates == 1
        assert not step.opt_disc.state
        after.append({k: v.detach().clone() for k, v in model.state_dict().items()})
        if frozen:
            assert m["train/mpd_gen"] == 0 and m["grad/mpd"] == 0
        else:
            assert m["train/mpd_gen"] > 0 and m["grad/mpd"] > 0
    p0 = _port_layout(model, _flat(run["params"]))
    for k, v in after[0].items():
        torch.testing.assert_close(after[1][k], v, rtol=0, atol=1e-7)
        if k.startswith("loss_m") and k in p0:
            np.testing.assert_array_equal(v.numpy(), p0[k])

    model = port_pair(run["params"], nan_guard=True)
    step = make_gan_step(model, MAX_STEPS)
    step(batch, draws=draws)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = [o.state_dict()["state"][0]["exp_avg"].clone()
                  for o in (step.opt_gen, step.opt_disc)]
    shadow = {k: v.clone() for k, v in step.ema.shadow.items()}
    bad = dict(batch, noisy=batch["noisy"] * float("nan"))
    m = step(bad, draws=draws)
    assert float(m["train/update_skipped"]) == 1.0
    assert (step.step, step.gen_updates, step.disc_updates, step.ema.num_updates) == (2, 1, 1, 1)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    for o, e in zip((step.opt_gen, step.opt_disc), opt_before):
        torch.testing.assert_close(o.state_dict()["state"][0]["exp_avg"], e, rtol=0, atol=0)
    for k, v in step.ema.shadow.items():
        torch.testing.assert_close(v, shadow[k], rtol=0, atol=0)
    m = step(batch, draws=draws)
    assert float(m["train/update_skipped"]) == 0.0 and step.gen_updates == 2


def test_dynamic_mixing_permutes_the_noise(gan_run):
    """dynamic_mixing: the step on (clean, clean + noise[perm]) equals the
    step without mixing on that batch."""
    run = gan_run
    clean = torch.from_numpy(run["batch"]["clean"])
    noisy = torch.from_numpy(run["batch"]["noisy"])
    perm = torch.tensor([1, 0])
    draws = {k: torch.from_numpy(v.copy()) for k, v in run["draws"][0].items()}
    states = []
    for mixing, batch in ((True, {"clean": clean, "noisy": noisy}),
                          (False, {"clean": clean, "noisy": clean + (noisy - clean)[perm]})):
        model = port_pair(run["params"], dynamic_mixing=mixing)
        make_gan_step(model, MAX_STEPS)(batch, draws=dict(draws, perm=perm))
        states.append(model.state_dict())
    for k, v in states[0].items():
        torch.testing.assert_close(v, states[1][k], rtol=0, atol=1e-7)


# ------------------------------------------------ optimizers, schedules, EMA
def test_schedules_match_jax():
    """The warmup-cosine schedule, held at eta_min past T_max, and its GAN
    use (two units per step; one while the discriminator is frozen) against
    the JAX package's, relative 1e-6."""
    sch = {"scheduler": {"T_warmup": 5, "T_cosine": 12, "eta_min": 1e-6, "T_max": 30}}
    for role in (None, "generator", "discriminator"):
        for freeze in (0, 4):
            j = _build_schedule(sch, 2e-4, 100, gan_role=role, freeze_step=freeze)
            p = poptim.build_schedule(sch, 2e-4, 100, gan_role=role, freeze_step=freeze)
            for i in range(0, 40):
                # near eta_min the JAX schedule's float32 cosine rounds at
                # the float32 spacing of base_lr
                err = abs(p(i) - float(j(i)))
                assert err <= max(1e-6 * abs(float(j(i))), 2 * np.spacing(np.float32(2e-4))), (
                    role, freeze, i)
    for s in range(0, 20):
        for f in (0, 3):
            assert poptim.gan_scheduler_units(s, f) == joptim.gan_scheduler_units(s, f)


def test_optimizers_clipping_and_ema_match_optax(rng):
    """Three updates on given gradients: the generator's AdamW (no decay on
    names holding prelu or bias, the frozen signal-decoupling group not
    updated), the discriminator's (every leaf decays at 0.01, biases too),
    per-group clipping (one group clipped, one not) and EMA against optax
    and the JAX package; relative 1e-6 of each tensor's largest value."""
    shapes = {"score_model": {"conv": {"weight": (4, 3), "bias": (3,)},
                              "prelu": {"weight": (1,)}},
              "condition_model": {"lin": {"weight": (5, 2)}},
              "signal_decoupling_layer": {"conv": {"weight": (3, 1)}},
              "loss_mpd": {"conv": {"weight": (2, 2), "bias": (2,)}}}
    params = jax.tree_util.tree_map(lambda s: rng.standard_normal(s).astype(np.float32),
                                    shapes, is_leaf=lambda x: isinstance(x, tuple))
    gen_keys = ["score_model", "condition_model", "signal_decoupling_layer"]
    gen_mask = {k: jax.tree_util.tree_map(lambda _: k != "signal_decoupling_layer",
                                          params[k]) for k in gen_keys}
    sch = {"scheduler": {"T_warmup": 2, "T_cosine": 3, "eta_min": 1e-6, "T_max": 5}}
    tx = joptim.adamw(_build_schedule(sch, 1e-2, 100, gan_role="generator"),
                      weight_decay=0.01, params={k: params[k] for k in gen_keys},
                      trainable_mask=gen_mask)
    tx_d = joptim.adamw(_build_schedule(sch, 1e-2, 100, gan_role="discriminator"),
                        weight_decay=0.01)
    gp = {k: params[k] for k in gen_keys}
    dp = {"loss_mpd": params["loss_mpd"]}
    st, st_d = tx.init(gp), tx_d.init(dp)
    ema = ema_init(params, gen_keys)

    class Holder(torch.nn.Module):
        def model_param_keys(self):
            return gen_keys

    def module(tree):
        m = torch.nn.Module()
        for k, v in tree.items():
            if isinstance(v, dict):
                m.add_module(k, module(v))
            else:
                m.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
        return m

    holder = Holder()
    for k in params:
        holder.add_module(k, module(params[k]))
    torch_params = dict(holder.named_parameters())
    named_gen = [(n, p) for n, p in torch_params.items()
                 if n.split(".")[0] in ("score_model", "condition_model")]
    opt = poptim.adamw(named_gen, weight_decay=0.01)
    opt_d = poptim.adamw([(n, p) for n, p in torch_params.items()
                          if n.startswith("loss_mpd")], weight_decay=0.01,
                         weight_decay_exclude=None)
    lr_g = poptim.build_schedule(sch, 1e-2, 100, gan_role="generator")
    lr_d = poptim.build_schedule(sch, 1e-2, 100, gan_role="discriminator")
    p_ema = EMA(holder, 0.999)
    for i in range(3):
        grads = jax.tree_util.tree_map(lambda v: rng.standard_normal(v.shape).astype(
            np.float32) * (30.0 if i == 1 else 1.0), params)
        g_gen = {k: grads[k] for k in gen_keys}
        g_gen, n_score = joptim.clip_subtree_by_norm(g_gen, ["score_model"], 5.0)
        g_gen, n_cond = joptim.clip_subtree_by_norm(
            g_gen, ["condition_model", "signal_decoupling_layer"], 5.0)
        upd, st = tx.update(g_gen, st, gp)
        gp = optax.apply_updates(gp, upd)
        upd, st_d = tx_d.update({"loss_mpd": grads["loss_mpd"]}, st_d, dp)
        dp = optax.apply_updates(dp, upd)
        ema = ema_update(ema, gp, 0.999)

        flat_g = {f"{k}.{n}": v for k in params for n, v in _flat(grads[k]).items()}
        for n, p in torch_params.items():
            p.grad = torch.from_numpy(flat_g[n].copy())
        ns = poptim.clip_by_norm_([torch_params[n].grad for n in torch_params
                                   if n.startswith("score_model")], 5.0)
        nc = poptim.clip_by_norm_([torch_params[n].grad for n in torch_params
                                   if n.split(".")[0] in ("condition_model",
                                                          "signal_decoupling_layer")], 5.0)
        assert _rel(float(ns), float(n_score)) <= 1e-6 and _rel(float(nc), float(n_cond)) <= 1e-6
        poptim.set_lr(opt, lr_g(i))
        poptim.set_lr(opt_d, lr_d(i))
        opt.step()
        opt_d.step()
        p_ema.update()

    want = {**{f"{k}.{n}": v for k in gen_keys for n, v in _flat(gp[k]).items()},
            **{f"loss_mpd.{n}": v for n, v in _flat(dp["loss_mpd"]).items()}}
    for n, p in torch_params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n],
                                   atol=1e-6 * np.abs(want[n]).max(), rtol=0, err_msg=n)
    start = {f"{k}.{n}": v for k in params for n, v in _flat(params[k]).items()}
    np.testing.assert_array_equal(torch_params["signal_decoupling_layer.conv.weight"]
                                  .detach().numpy(),
                                  start["signal_decoupling_layer.conv.weight"])
    # the disc's bias decays as optax decays every disc leaf (held above)
    assert not np.allclose(want["loss_mpd.conv.bias"], start["loss_mpd.conv.bias"])
    shadow = {f"{k}.{n}": v for k in gen_keys for n, v in _flat(ema["shadow"][k]).items()}
    assert set(p_ema.shadow) == set(shadow)
    for n, v in p_ema.shadow.items():
        np.testing.assert_allclose(v.numpy(), shadow[n], atol=1e-6 * np.abs(shadow[n]).max(),
                                   rtol=0, err_msg=n)


def test_clippers_match_jax(rng):
    """FixedClipper and AutoClipper (ring-buffer percentile) on the same
    gradient norms, clipping and not."""
    for jc, pc in ((joptim.FixedClipper(3.0), poptim.FixedClipper(3.0)),
                   (joptim.AutoClipper(50.0, history_size=4),
                    poptim.AutoClipper(50.0, history_size=4))):
        state = jc.init()
        for scale in (1.0, 5.0, 0.2, 9.0, 1.0, 3.0):
            g = (rng.standard_normal((6,)) * scale).astype(np.float32)
            gj, state, nj, cj = jc({"a": jnp.asarray(g)}, state)
            gp = torch.from_numpy(g.copy())
            npn, cp = pc([gp])
            assert _rel(float(npn), float(nj)) <= 1e-6 and _rel(float(cp), float(cj)) <= 1e-6
            np.testing.assert_allclose(gp.numpy(), np.asarray(gj["a"]), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ configs, data
def test_compose_matches_jax():
    """Every experiment composes to the JAX package's resolved dict."""
    for f in sorted((ROOT / "config" / "experiment").glob("*.yaml")):
        ov = [f"experiment={f.stem}", "trainer.max_steps=7"]
        assert port_compose(ROOT / "config", ov) == jax_compose(ROOT / "config", ov), f.stem


def _write_pairs(root, lengths, rng, extra_noisy=()):
    from scipy.io import wavfile

    for d in ("noisy", "clean"):
        (root / "train" / d).mkdir(parents=True, exist_ok=True)
    for i, n in enumerate(lengths):
        c = rng.standard_normal(n) * 0.05
        for d, x in (("clean", c), ("noisy", c + rng.standard_normal(n) * 0.02)):
            wavfile.write(root / "train" / d / f"f{i:02d}.wav", FS,
                          (x * 32767).astype(np.int16))
    for name in extra_noisy:
        wavfile.write(root / "train" / "noisy" / name, FS, np.zeros(900, np.int16))


def test_dataset_and_loader_match_jax(tmp_path, rng):
    """The same file list (a noisy file without its clean pair is dropped),
    the same random crops and shuffles over two epochs, and the same tiling
    of a clip shorter than the crop, as the JAX package's loader."""
    _write_pairs(tmp_path, [1200, 900, 2000, 700, 1500], rng, extra_noisy=("lone.wav",))
    ds_cfg = {"_target_": "open_universe_tpu.datasets.NoisyDataset",
              "audio_path": str(tmp_path), "fs": FS, "split": "train", "audio_len": 0.05}
    dm_cfg = {"_target_": "open_universe_tpu.datasets.DataModule",
              "train": {"dataset": "d", "dl_opts": {"batch_size": 2, "shuffle": True}},
              "val": {"dataset": "d"}, "test": {"dataset": "d"}, "datasets": {"d": ds_cfg}}
    jdm, pdm = jregistry.instantiate(dm_cfg), pregistry.instantiate(dm_cfg)
    assert isinstance(pdm, pdataset.DataModule) and isinstance(jdm, jdataset.DataModule)
    jl, pl = jdm.train_dataloader(), pdm.train_dataloader()
    for _ in range(2):
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == 2
        for a, b in zip(jb, pb):
            assert a["key"] == b["key"]
            for k in ("noisy", "clean", "length"):
                np.testing.assert_array_equal(a[k], b[k])
    assert "lone" not in pdm.datasets["train"].file_list


# ------------------------------------------------------------ entry point
def test_train_entry_point_writes_a_checkpoint_load_model_reads(tmp_path, rng):
    """``python -m open_universe_tpu_torch.train`` on the CPU (a tiny model
    on temp WAVs, 3 steps) imports nothing of JAX and writes a checkpoint
    with its config beside it; ``load_model`` reads it with the EMA shadows
    as weights (equal to the checkpoint's shadow list, apart from the
    trainer's raw weights) and ``enhance`` runs on them."""
    from open_universe_tpu_torch.inference.model_loader import load_model, ordered_param_names

    _write_pairs(tmp_path / "data", [2000] * 4, rng)
    d = "model.losses.multi_period_discriminator."
    r = "model.losses.multi_resolution_discriminator."
    overrides = [
        "experiment=universepp_vb_16k", "device=cpu",
        "model.score_model.n_channels=4", "model.score_model.noise_cond_dim=32",
        "model.condition_model.n_mels=16", f"{d}mpd_reshapes=[2,3]",
        f"{d}discriminator_channel_mult=0.25", f"{r}discriminator_channel_mult=0.25",
        f"{r}resolutions=[[128,30,75],[256,60,150],[64,12,30]]",
        f"datamodule.datasets.vb-train-16k.audio_path={tmp_path / 'data'}",
        "datamodule.datasets.vb-train-16k.audio_len=0.05",
        "datamodule.train.dl_opts.batch_size=2", "trainer.max_steps=3",
        "trainer.val_check_interval=1000", "trainer.checkpoint_every=3",
        "trainer.log_every=1", f"path.exp_root={tmp_path / 'exp'}"]
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['train'] + {overrides!r}\n"
        "runpy.run_module('open_universe_tpu_torch.train', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'open_universe_tpu' or m.startswith('open_universe_tpu.')]\n"
        "assert not bad, bad\n")
    # one intra-op thread: the test workers share the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    (ckpt,) = (tmp_path / "exp").glob("universepp_vb_16k/*/checkpoints/step_00000003.ckpt")
    assert (ckpt.parent / "config.yaml").exists()
    rows = [json.loads(line) for line in
            (ckpt.parents[1] / "metrics.jsonl").read_text().splitlines()]
    assert [row["step"] for row in rows] == [1, 2, 3]
    assert all(np.isfinite(row["train/loss_gen"]) for row in rows)

    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert saved["ema"]["num_updates"] == 3
    assert any(k.startswith("loss_mpd.") for k in saved["state_dict"])
    names = ordered_param_names(saved["state_dict"],
                                ["score_model", "condition_model", "signal_decoupling_layer"])
    shadow = dict(zip(names, saved["ema"]["shadow_params"]))
    model = load_model(ckpt, fold_wn=False, device="cpu")
    loaded = model.state_dict()
    differ = 0
    for name, s in shadow.items():
        torch.testing.assert_close(loaded[name], s, rtol=0, atol=0)
        differ += not torch.equal(s, saved["state_dict"][name])
    assert differ > len(shadow) // 2
    assert not hasattr(model, "loss_mpd")
    mix = torch.from_numpy(rng.standard_normal((1, 1600)).astype(np.float32)) * 0.05
    est = model.enhance(mix, n_steps=2, generator=torch.Generator().manual_seed(0))
    assert est.shape == (1, 1600) and bool(torch.isfinite(est).all())


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port and not chip_smoke.py imports jax,
    open_universe_tpu, flax, optax, transformers or safetensors; the plain
    UNIVERSE's modules (the MDN loss, the transforms, the score-only step),
    LoRA fine-tuning's (the losses, the adapters, the enhancement family,
    UniverseLoRA), training at scale's (data parallelism, the parity and
    resample CLIs, the parameter utilities, the reference-path aliases) and
    the phoneme losses' (the wav2vec2 model, the losses, LPS) are among
    them, and importing them loads none of these."""
    import re

    banned = ("jax", "open_universe_tpu", "flax", "optax", "transformers", "safetensors")
    pat = re.compile(r"^\s*(from|import)\s+(" + "|".join(banned) + r")(\s|\.|$)", re.M)
    files = sorted((ROOT / "open_universe_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    new = ["models/mdn.py", "models/transforms.py", "train/steps.py", "ops/stft.py",
           "losses/__init__.py", "losses/multires_stft.py", "losses/combine.py",
           "nn/lora.py", "lora.py", "models/enhancement.py", "models/universe_lora.py",
           "parallel/mesh.py", "utils/params.py", "bin/parity.py", "bin/resample.py",
           "prepare/resample.py", "networks/universe.py", "datasets.py",
           "inference_utils.py", "layers.py", "nn/wav2vec2.py", "losses/phoneme_loss.py",
           "metrics/lps.py"]
    assert {ROOT / "open_universe_tpu_torch" / n for n in new} <= set(files)
    for f in files:
        assert not pat.search(f.read_text()), f
    mods = ", ".join("open_universe_tpu_torch." + n[:-3].replace("/", ".").replace(
        ".__init__", "") for n in new)
    code = (f"import {mods}\n"
            "import sys\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {banned!r}]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-2000:]
