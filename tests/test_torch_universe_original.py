"""The plain UNIVERSE's score-only training step in the PyTorch port
against the JAX package's ``make_train_step``, at float32 on the CPU: one
step's gradients of every parameter (the MDN loss modules' included), two
steps with AdamW, the clipper and EMA, ``nan_guard``'s rollback with either
clipper, and a UNIVERSE++'s ``compute_losses(train=True)``.

The model is the ``universe_original_vb_16k`` experiment at a narrow width
(4 channels, rate factors [2, 4], 16 mels) with 800-sample crops, so the
MDN LayerNorms are (4, 800) and (32, 100).  Weights are drawn with numpy
into the JAX param tree and carried over with ``from_jax_params``; the
draws of a step are JAX's, split as ``training_losses`` splits its key.
JAX's step is compiled once for the module.  Bounds: the losses and
gradient norms <= 1e-5 relative; gradients per tensor <= 1e-5 of the
tensor's largest (1e-4 for a one-element PReLU slope, one sum over the
batch); parameter and EMA changes as ``test_torch_train._check_deltas``.
``test_torch_mdn.py`` holds the loss modules, the losses and ``enhance``.
"""
import copy
from pathlib import Path

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

jax = pytest.importorskip("jax")
import optax  # noqa: E402
import torch  # noqa: E402

from open_universe_tpu.configs import registry as jregistry  # noqa: E402
from open_universe_tpu.configs.resolve import compose as jax_compose  # noqa: E402
from open_universe_tpu.nn.module import buffer_mask  # noqa: E402
from open_universe_tpu.train import optim as joptim  # noqa: E402
from open_universe_tpu.train.steps import init_train_state, make_train_step  # noqa: E402
from open_universe_tpu.train.trainer import _build_schedule  # noqa: E402
from open_universe_tpu_torch.configs import registry as pregistry  # noqa: E402
from open_universe_tpu_torch.configs.resolve import compose as port_compose  # noqa: E402
from open_universe_tpu_torch.ops.kernels import conv_block  # noqa: E402
from open_universe_tpu_torch.train import optim as poptim  # noqa: E402
from open_universe_tpu_torch.train.trainer import make_step  # noqa: E402
from open_universe_tpu_torch.utils.convert import from_jax_params  # noqa: E402
from test_torch_train import (  # noqa: E402
    _capture,
    _check_deltas,
    _flat,
    _port_layout,
    _rel,
    draw_params,
)

ROOT = Path(__file__).resolve().parents[1]
B, T, MAX_STEPS = 2, 800, 300000
TOL = 1e-5
NARROW = ["experiment=universe_original_vb_16k", "model.score_model.n_channels=4",
          "model.score_model.noise_cond_dim=32", "model.score_model.rate_factors=[2,4]",
          "model.condition_model.n_mels=16", "model.diffusion.n_steps=3",
          # warmup over 2 updates: the updates are lr / 2 and lr, not ~lr / 50000
          "model.scheduler.scheduler.T_warmup=2", "model.scheduler.scheduler.T_cosine=3",
          f"datamodule.datasets.vb-train-16k.audio_len={T / 16000}"]


def config(*extra):
    ov = NARROW + list(extra)
    return jax_compose(ROOT / "config", ov)["model"], port_compose(ROOT / "config", ov)["model"]


def loss_draws(key, shape=(B, T, 1)):
    """``training_losses``' draws for ``key``: the permutation from k_mix,
    then sigma's uniforms and the score's noise from k_loss's split."""
    k_mix, k_loss = jax.random.split(key)
    k_sigma, k_noise = jax.random.split(k_loss)
    return {"perm": np.asarray(jax.random.permutation(k_mix, shape[0])),
            "u": np.asarray(jax.random.uniform(k_sigma, (shape[0],))),
            "z": np.asarray(jax.random.normal(k_noise, shape))}


def torch_draws(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def make_batch(seed=1):
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((B, T, 1)) * 0.05).astype(np.float32)
    return {"clean": clean,
            "noisy": clean + (rng.standard_normal((B, T, 1)) * 0.02).astype(np.float32)}


def port_model(cfg, params):
    model = pregistry.instantiate_trainable(cfg)
    assert from_jax_params(model, params) == []
    return model


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):  # numpy's BLAS too
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    """Two steps of JAX's ``make_train_step`` (AdamW with the experiment's
    decay and exclusions, its schedule, the FixedClipper, EMA), jitted
    once, from numpy weights; step 1's gradients as the optimizer gets them
    (the clip at 1000 leaves them), each step's draws and metrics."""
    jcfg, pcfg = config()
    jm = jregistry.instantiate(jcfg)
    params = jax.tree_util.tree_map(np.asarray, draw_params(jm, seed=7))
    opt = jcfg["optimizer"]
    tx = optax.chain(_capture(), joptim.adamw(
        _build_schedule(jcfg["scheduler"], opt["lr"], MAX_STEPS), betas=tuple(opt["betas"]),
        weight_decay=opt["weight_decay"], weight_decay_exclude=opt["weight_decay_exclude"],
        params=params, trainable_mask=buffer_mask(jm, params)))
    clipper = joptim.make_clipper({"max_norm": jcfg["grad_clipper"]["max_norm"]})
    states = [init_train_state(jm, params, tx, clipper=clipper)]
    step = jax.jit(make_train_step(jm, tx, clipper=clipper))
    batch = make_batch()
    keys = [jax.random.key(20), jax.random.key(21)]
    metrics = []
    for key in keys:
        st, m = step(states[-1], batch, key)
        states.append(st)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(jm=jm, pcfg=pcfg, params=params, batch=batch, metrics=metrics,
                draws=[loss_draws(k) for k in keys], grads=_flat(states[1]["opt_state"][0]),
                states=[jax.tree_util.tree_map(np.asarray, s) for s in states])


def _port_steps(run, n, **training):
    cfg = copy.deepcopy(run["pcfg"])
    cfg["training"].update(training)
    model = port_model(cfg, run["params"])
    step = make_step(model, MAX_STEPS)
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    metrics = [{k: float(v) for k, v in step(batch, draws=torch_draws(run["draws"][i])).items()}
               for i in range(n)]
    return model, step, metrics


def test_gan_universe_train_losses_are_the_score_loss(run):
    """A UNIVERSE++ has no MDN losses: its ``compute_losses(train=True)`` is
    (score, score, 0, 0, time), as JAX's (whose UniverseGAN overrides
    ``init_losses``; ``test_torch_validate`` holds it against JAX)."""
    from open_universe_tpu_torch.nn.layers import init_weights
    from test_torch_train import gan_config

    model = init_weights(pregistry.instantiate_trainable(gan_config()), seed=0)
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    (mix, target), *_ = model.normalize_batch((batch["noisy"], batch["clean"]))
    d = torch_draws(run["draws"][0])
    with torch.no_grad():
        loss, l_score, l_signal, l_latent, time = model.compute_losses(
            mix, target, u=d["u"], z=d["z"])
        want = model.compute_losses(mix, target, train=False, u=d["u"], z=d["z"])
    assert float(loss) == float(l_score) == float(want)
    assert float(l_signal) == float(l_latent) == 0.0 and time.shape == (B,)


# ------------------------------------------------------------ the step
def test_train_step_gradients_match_jax(run, monkeypatch, record_property):
    """Step 1's gradient of every parameter (the MDN heads and LayerNorms
    included) against jax.grad's, as the optimizer gets them (the clip at
    1000 leaves them), and ``grad/norm``; no ConvBlock of the step takes the
    fused chain (it has no backward)."""
    calls = []
    real = conv_block.fused_conv_chain_reference
    monkeypatch.setattr(conv_block, "fused_conv_chain_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model, _, metrics = _port_steps(run, 1)
    assert not calls
    want_m = run["metrics"][0]
    assert want_m["grad/norm"] < 1000.0
    for k in ("grad/norm", "grad/clipped_norm"):
        assert _rel(metrics[0][k], want_m[k]) <= TOL, k
    want = _port_layout(model, run["grads"])
    params = dict(model.named_parameters())
    # JAX's tree holds the SigmaBlock's frequencies, which the mask freezes;
    # the port keeps them as a buffer
    assert set(want) - set(params) == {"score_model.sigma_block.freq"}
    want.pop("score_model.sigma_block.freq")
    assert set(want) == set(params)
    assert any(n.startswith("loss_signal.layer_norm") for n in params)
    rel = {}
    for name, g_j in want.items():
        g_p = params[name].grad.numpy()
        scale = np.abs(g_j).max()
        assert scale > 0, name
        rel[name] = float(np.abs(g_p - g_j).max() / scale)
        assert rel[name] <= (1e-4 if g_j.size == 1 else TOL), (name, rel[name])
    record_property("grad_rel_max", max(rel.values()))
    record_property("grad_rel_median", float(np.median(list(rel.values()))))


def test_two_train_steps_match_jax(run, record_property):
    """Two full steps against make_train_step: every parameter's change and
    every EMA shadow's (score and conditioner networks only), per tensor
    (``_check_deltas``); the learning rates of the two updates are the
    schedule's at 0 and 1."""
    model, step, metrics = _port_steps(run, 2)
    assert (step.step, step.updates, step.ema.num_updates) == (2, 2, 2)
    assert set(step.ema.shadow) == {n for n, _ in model.named_parameters()
                                    if n.split(".")[0] in ("score_model", "condition_model")}
    for got, want in zip(metrics, run["metrics"]):
        assert _rel(got["train/loss"], want["train/loss"]) <= TOL
    p0 = _port_layout(model, _flat(run["params"]))
    p2 = _port_layout(model, _flat(run["states"][2]["params"]))
    e2 = _port_layout(model, _flat(run["states"][2]["ema"]["shadow"]))
    g1 = _port_layout(model, run["grads"])
    lr = float(step.lr(1))
    flips, worst = 0, 0.0
    for name, p in model.named_parameters():
        d_port, d_jax = p.detach().numpy() - p0[name], p2[name] - p0[name]
        assert np.abs(d_jax).max() > 0, name
        n_small, rel = _check_deltas(name, p0[name], d_port, d_jax, g1[name], lr)
        flips, worst = flips + n_small, max(worst, rel)
        if name in e2:
            s = step.ema.shadow[name].numpy()
            n_small, rel = _check_deltas(name + " (EMA)", p0[name], s - p0[name],
                                         e2[name] - p0[name], g1[name], lr)
            flips, worst = flips + n_small, max(worst, rel)
    n = sum(p.numel() for p in model.parameters())
    record_property("small_gradient_elements_over_bound", flips)
    record_property("worst_rel_delta", worst)
    assert flips <= 1e-3 * n, (flips, n)


@pytest.mark.parametrize("clipper", ["fixed", "auto"])
def test_nan_guard_rolls_back(run, clipper):
    """With nan_guard a step on a non-finite batch changes no parameter,
    optimizer state, EMA shadow or AutoClip history, reports
    ``train/update_skipped`` 1, and the step count moves on; the next
    finite step updates."""
    cfg = copy.deepcopy(run["pcfg"])
    cfg["training"]["nan_guard"] = True
    if clipper == "auto":
        cfg["grad_clipper"] = {"p": 50.0, "history_size": 4}
    model = port_model(cfg, run["params"])
    step = make_step(model, MAX_STEPS)
    assert isinstance(step.clipper, poptim.AutoClipper if clipper == "auto"
                      else poptim.FixedClipper)
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    draws = torch_draws(run["draws"][0])
    step(batch, draws=draws)
    before = copy.deepcopy((model.state_dict(), step.opt.state_dict(), step.ema.shadow,
                            step.clipper.__dict__))
    m = step(dict(batch, noisy=batch["noisy"] * float("nan")), draws=draws)
    assert float(m["train/update_skipped"]) == 1.0
    assert (step.step, step.updates, step.ema.num_updates) == (2, 1, 1)
    after = (model.state_dict(), step.opt.state_dict(), step.ema.shadow, step.clipper.__dict__)
    _assert_same(before, after)
    m = step(batch, draws=draws)
    assert float(m["train/update_skipped"]) == 0.0 and step.updates == 2


def _assert_same(a, b, path=""):
    """Two nested states are equal, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    else:
        assert a == b, path
