"""Mixed precision (``training.compute_dtype: bf16``) and recomputation
(``training.remat``) of the PyTorch port's training, on the CPU, for
UNIVERSE++ (the GAN parts) and the plain UNIVERSE (the score-only
objective with its MDN losses).

bf16 against the JAX package's bf16 (its ``_cast_tree`` policy, jitted once
per family for the module) on the same weights and draws (JAX draws the
score noise in bfloat16; its values are handed to the port): every loss
within 2e-2 (|JAX| + 1).  bf16 against the port's own float32: JAX's own
loose bound, 0.1 (|f32| + 1) (``tests/test_train_steps.py``).  After a bf16
step every parameter, gradient, Adam moment and EMA shadow is float32.
Remat against no remat, same dtype, weights and draws: every loss and
every gradient within 1e-6 relative (of the tensor's largest).
"""
import copy

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from open_universe_tpu.configs import registry as jregistry  # noqa: E402
from open_universe_tpu_torch.configs import registry as pregistry  # noqa: E402
from open_universe_tpu_torch.train import trainer as ptrainer  # noqa: E402
from open_universe_tpu_torch.utils.convert import from_jax_params  # noqa: E402
from test_torch_train import MAX_STEPS, _rel, draw_params, gan_config  # noqa: E402
from test_torch_universe_original import config as orig_config  # noqa: E402

B, T = 2, 800
BF16_TOL = 2e-2


def narrow(cfg, **training):
    cfg = copy.deepcopy(cfg)
    for k in ("score_model", "condition_model"):
        cfg[k]["rate_factors"] = [2, 4]
    cfg["losses"]["multi_period_discriminator"]["mpd_reshapes"] = [2]
    cfg["training"].update(training)
    return cfg


def make_batch(seed=1):
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((B, T, 1)) * 0.05).astype(np.float32)
    return {"clean": clean,
            "noisy": clean + (rng.standard_normal((B, T, 1)) * 0.02).astype(np.float32)}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):  # numpy's BLAS too
        yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ UNIVERSE++
def gan_losses_jax(jm, params, batch, key):
    """The GAN step's losses before any update (make_gan_train_step's
    forward, the discriminators' loss, the generator's against the same
    discriminators)."""
    _, k_fwd = jax.random.split(key)
    (mix, target, orig), *_ = jm.normalize_batch(
        (batch["noisy"], batch["clean"], batch["clean"]))
    out = jm.generator_forward(params, k_fwd, mix, target, orig)
    disc = {k: params[k] for k in jm.disc_param_keys()}
    _, d_metrics = jm.discriminator_losses(disc, out["y_est"], orig)
    _, g_metrics = jm.generator_losses(disc, out, orig, 0, True)
    return {**d_metrics, **g_metrics}


def gan_draws(key, dtype):
    _, k_fwd = jax.random.split(key)
    k_sigma, k_noise = jax.random.split(k_fwd)
    return {"u": np.asarray(jax.random.uniform(k_sigma, (B,))),
            "z": np.asarray(jax.random.normal(k_noise, (B, T, 1), dtype), np.float32)}


def gan_losses_port(model, batch, draws):
    with torch.no_grad():
        (mix, target, orig), *_ = model.normalize_batch(
            (batch["noisy"], batch["clean"], batch["clean"]))
        out = model.generator_forward(mix, target, orig, u=draws["u"], z=draws["z"])
        _, d_metrics = model.discriminator_losses(out["y_est"], orig)
        _, g_metrics = model.generator_losses(out, orig, True)
    return {k: float(v) for k, v in {**d_metrics, **g_metrics}.items()}


@pytest.fixture(scope="module")
def gan_bf16():
    cfg = narrow(gan_config(), compute_dtype="bf16")
    jm = jregistry.instantiate(cfg)
    params = jax.tree_util.tree_map(np.asarray, draw_params(jm, seed=5))
    batch, key = make_batch(), jax.random.key(3)
    want = jax.jit(lambda p, b: gan_losses_jax(jm, p, b, key))(params, batch)
    return dict(cfg=cfg, params=params, batch=batch, draws=gan_draws(key, jnp.bfloat16),
                want={k: float(v) for k, v in want.items()})


def gan_port(run, **training):
    cfg = copy.deepcopy(run["cfg"])
    cfg["training"].update(training)
    model = pregistry.instantiate_trainable(cfg)
    assert from_jax_params(model, run["params"]) == []
    return model


def test_gan_bf16_losses_match_jax_bf16(gan_bf16, record_property):
    """Every GAN loss term in bf16 within 2e-2 (|JAX| + 1) of JAX's bf16,
    and within 0.1 (|f32| + 1) of the port's float32 on the same draws."""
    run = gan_bf16
    got = gan_losses_port(gan_port(run), _t(run["batch"]), _t(run["draws"]))
    f32 = gan_losses_port(gan_port(run, compute_dtype=None), _t(run["batch"]),
                          _t(run["draws"]))
    assert set(got) == set(run["want"])
    worst = 0.0
    for k, v in run["want"].items():
        err = abs(got[k] - v) / (abs(v) + 1.0)
        worst = max(worst, err)
        assert err <= BF16_TOL, (k, got[k], v)
        assert abs(got[k] - f32[k]) <= 0.1 * (abs(f32[k]) + 1.0), (k, got[k], f32[k])
    assert any(got[k] != f32[k] for k in got)  # the networks did run in bf16
    record_property("bf16_vs_jax_bf16_max", worst)


def _state_dtypes(model, step, opts):
    bad = [n for n, p in model.named_parameters()
           if p.dtype != torch.float32 or (p.grad is not None and p.grad.dtype != torch.float32)]
    for opt in opts:
        bad += [k for st in opt.state.values() for k, v in st.items()
                if torch.is_tensor(v) and v.is_floating_point() and v.dim() > 0
                and v.dtype != torch.float32]
    bad += [n for n, s in step.ema.shadow.items() if s.dtype != torch.float32]
    return bad


def test_gan_bf16_step_keeps_float32_state(gan_bf16):
    """One bf16 GAN step: finite losses; the parameters, gradients, both
    AdamW states and the EMA shadows are float32."""
    run = gan_bf16
    model = gan_port(run)
    step = ptrainer.make_gan_step(model, MAX_STEPS)
    m = step(_t(run["batch"]), draws=_t(run["draws"]))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert step.opt_gen.state and step.opt_disc.state
    assert _state_dtypes(model, step, (step.opt_gen, step.opt_disc)) == []


def _count_checkpoints(monkeypatch):
    """Count torch.utils.checkpoint calls of the models' remat."""
    from open_universe_tpu_torch.models import universe as puniverse

    calls, real = [], puniverse.checkpoint
    monkeypatch.setattr(puniverse, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _grads_after_step(model, step, batch, draws):
    m = step(batch, draws=draws)
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})


def _same(a, b, record_property, tag):
    for k in a[0]:
        assert _rel(a[0][k], b[0][k]) <= 1e-6 or a[0][k] == b[0][k], (tag, k)
    assert set(a[1]) == set(b[1])
    worst = 0.0
    for n, g in a[1].items():
        err = (g - b[1][n]).abs().max().item() / max(b[1][n].abs().max().item(), 1e-30)
        worst = max(worst, err)
        assert err <= 1e-6, (tag, n, err)
    record_property(f"{tag}_grad_rel_max", worst)


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_gan_remat_equals_no_remat(gan_bf16, dtype, record_property, monkeypatch):
    """One GAN step with and without remat (the conditioner's and the
    score's forwards recomputed in the backward: 2 checkpointed calls): the
    losses and every gradient within 1e-6 relative."""
    run = gan_bf16
    calls = _count_checkpoints(monkeypatch)
    out = []
    for remat in (False, True):
        model = gan_port(run, compute_dtype=dtype, remat=remat)
        out.append(_grads_after_step(model, ptrainer.make_gan_step(model, MAX_STEPS),
                                     _t(run["batch"]), _t(run["draws"])))
        assert len(calls) == 2 * remat
    _same(out[1], out[0], record_property, f"gan_{dtype}")


# ------------------------------------------------------------------ plain UNIVERSE
def orig_draws(key, dtype):
    k_mix, k_loss = jax.random.split(key)
    k_sigma, k_noise = jax.random.split(k_loss)
    return {"u": np.asarray(jax.random.uniform(k_sigma, (B,))),
            "z": np.asarray(jax.random.normal(k_noise, (B, T, 1), dtype), np.float32)}


@pytest.fixture(scope="module")
def orig_bf16():
    jcfg, pcfg = orig_config("model.training.compute_dtype=bf16")
    jm = jregistry.instantiate(jcfg)
    params = jax.tree_util.tree_map(np.asarray, draw_params(jm, seed=7))
    batch, key = make_batch(2), jax.random.key(4)
    _, metrics = jax.jit(lambda p, b: jm.training_losses(p, key, b["noisy"], b["clean"]))(
        params, batch)
    return dict(cfg=pcfg, params=params, batch=batch, draws=orig_draws(key, jnp.bfloat16),
                want={k: float(v) for k, v in metrics.items()})


def orig_port(run, **training):
    cfg = copy.deepcopy(run["cfg"])
    cfg["training"].update(training)
    model = pregistry.instantiate_trainable(cfg)
    assert from_jax_params(model, run["params"]) == []
    return model


def test_original_bf16_losses_match_jax_bf16(orig_bf16, record_property):
    """The score loss, both MDN losses and their total in bf16 within 2e-2
    (|JAX| + 1) of JAX's bf16, and within 0.1 (|f32| + 1) of the port's
    float32 on the same draws."""
    run = orig_bf16
    got, f32 = ({k: float(v) for k, v in orig_port(run, compute_dtype=dt).training_losses(
        *(torch.from_numpy(run["batch"][k]) for k in ("noisy", "clean")),
        draws=_t(run["draws"]))[1].items()} for dt in ("bf16", None))
    worst = 0.0
    for k, v in run["want"].items():
        err = abs(got[k] - v) / (abs(v) + 1.0)
        worst = max(worst, err)
        assert err <= BF16_TOL, (k, got[k], v)
        assert abs(got[k] - f32[k]) <= 0.1 * (abs(f32[k]) + 1.0), (k, got[k], f32[k])
    assert any(got[k] != f32[k] for k in got)  # the networks did run in bf16
    record_property("bf16_vs_jax_bf16_max", worst)


def test_original_bf16_step_keeps_float32_state(orig_bf16):
    """One bf16 score-only step: finite losses; parameters (the MDN loss
    modules' included), gradients, AdamW state and EMA float32."""
    run = orig_bf16
    model = orig_port(run)
    step = ptrainer.make_step(model, MAX_STEPS)
    m = step(_t(run["batch"]), draws=_t(run["draws"]))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert _state_dtypes(model, step, (step.opt,)) == []


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_original_remat_equals_no_remat(orig_bf16, dtype, record_property, monkeypatch):
    """The score-only step with and without remat (2 checkpointed calls):
    losses and every gradient within 1e-6 relative."""
    run = orig_bf16
    calls = _count_checkpoints(monkeypatch)
    out = []
    for remat in (False, True):
        model = orig_port(run, compute_dtype=dtype, remat=remat)
        out.append(_grads_after_step(model, ptrainer.make_step(model, MAX_STEPS),
                                     _t(run["batch"]), _t(run["draws"])))
        assert len(calls) == 2 * remat
    _same(out[1], out[0], record_property, f"original_{dtype}")
