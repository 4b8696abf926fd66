"""The plain UNIVERSE's loss modules and losses in the PyTorch port against
the JAX package, at float32 on the CPU: ``LayerNorm``, the mixture-density
loss (each reduction, alpha per sample or per clip, a 4-D target) and its
sampler, ``finite_or_skip`` with an inf injected into the estimate,
``compute_losses(train=True)`` through ``training_losses`` (plain, with
``with_noise_target``, with ``dynamic_mixing``), and ``enhance`` at the
``universe_original`` topology (SigmaBlock time embedding, no weight norm,
no anti-aliasing) through the fused chain's plain version.

The model is ``test_torch_universe_original.py``'s narrow
``universe_original_vb_16k``.  Bounds: the losses, the MDN loss and
LayerNorm <= 1e-5 relative (of max|ref| for tensors, and for gradients);
``enhance`` <= 2e-5, the sampler-golden bound of PARITY.md.
"""
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from open_universe_tpu.configs import registry as jregistry  # noqa: E402
from open_universe_tpu.models import mdn as jmdn  # noqa: E402
from open_universe_tpu.models.universe import finite_or_skip as jax_finite_or_skip  # noqa: E402
from open_universe_tpu.nn import LayerNorm as JaxLayerNorm  # noqa: E402
from open_universe_tpu_torch.configs import registry as pregistry  # noqa: E402
from open_universe_tpu_torch.models import mdn as pmdn  # noqa: E402
from open_universe_tpu_torch.models.universe import finite_or_skip  # noqa: E402
from open_universe_tpu_torch.nn.layers import LayerNorm  # noqa: E402
from open_universe_tpu_torch.ops.kernels import conv_block  # noqa: E402
from open_universe_tpu_torch.utils.convert import from_jax_params  # noqa: E402
from test_torch_enhance import _jax_draws  # noqa: E402
from test_torch_train import _flat, _port_layout, _rel, draw_params  # noqa: E402
from test_torch_universe_original import (  # noqa: E402
    B,
    config,
    loss_draws,
    make_batch,
    port_model,
    torch_draws,
)

TOL, ENH_TOL = 1e-5, 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):  # numpy's BLAS too
        yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the MDN parts
def test_layer_norm_matches_jax(rng):
    """Over the trailing (C, T) dims of (B, C, T), with drawn affine
    parameters: <= 1e-5 of max|ref|."""
    x = (rng.standard_normal((3, 6, 50)) * 2.0 + 0.5).astype(np.float32)
    w = rng.standard_normal((6, 50)).astype(np.float32)
    b = rng.standard_normal((6, 50)).astype(np.float32)
    want = np.asarray(jax.jit(JaxLayerNorm((6, 50)).apply)({"weight": w, "bias": b}, x))
    ln = LayerNorm((6, 50))
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
        got = ln(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)


def _mdn_pair(seed, **kw):
    jl = jmdn.MixtureDensityNetworkLoss(**kw)
    pl = pmdn.MixtureDensityNetworkLoss(**kw)
    params = draw_params(jl, seed=seed)
    params["layer_norm"]["weight"] = params["layer_norm"]["weight"] + 1.0
    assert from_jax_params(pl, params) == []
    return jl, pl, params


@pytest.mark.parametrize("alpha_per_sample,reduction,four_d", [
    (True, "mean", False), (False, "sum", False), (True, "none", True), (False, "mean", True)])
def test_mdn_loss_matches_jax(rng, alpha_per_sample, reduction, four_d, record_property):
    """The NLL and its gradients with respect to the estimate and the head's
    parameters, each reduction, alpha per sample or per clip, and a 4-D
    (B, 2, T, M) target folded channel-major: relative <= 1e-5 (the
    per-component sums run over T x targets terms), gradients <= 1e-5 of
    max|ref|.  An estimate longer than the LayerNorm's crop raises on both
    sides."""
    kw = dict(est_channels=6, tgt_channels=10 if four_d else 3, n_comp=3,
              sampling_rate=1000, sample_len_s=0.04, alpha_per_sample=alpha_per_sample,
              reduction=reduction)
    jl, pl, params = _mdn_pair(3, **kw)
    est = rng.standard_normal((2, 40, 6)).astype(np.float32)
    tgt = (rng.standard_normal((2, 2, 40, 5) if four_d else (2, 40, 3)) * 0.5).astype(np.float32)

    def f(p, e):
        return jnp.sum(jl(p, e, tgt))

    want = np.asarray(jax.jit(jl.apply)(params, est, tgt))
    g_p, g_e = jax.jit(jax.grad(f, argnums=(0, 1)))(params, est)
    e = torch.from_numpy(est).requires_grad_(True)
    got = pl(e, torch.from_numpy(tgt))
    got.sum().backward()
    assert got.shape == want.shape
    err = float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())
    record_property("rel", err)
    assert err <= TOL
    _close_grads(pl, g_p, e.grad, g_e)
    with pytest.raises(ValueError, match="40 frames"):
        pl(torch.zeros(2, 41, 6), torch.zeros(2, 41, 3))
    with pytest.raises((TypeError, ValueError)):
        jl(params, jnp.zeros((2, 41, 6)), jnp.zeros((2, 41, 3)))


def _close_grads(module, g_params_jax, g_est, g_est_jax):
    np.testing.assert_allclose(g_est.numpy(), np.asarray(g_est_jax),
                               atol=TOL * np.abs(np.asarray(g_est_jax)).max(), rtol=0)
    want = _port_layout(module, _flat(g_params_jax))
    for name, p in module.named_parameters():
        scale = max(np.abs(want[name]).max(), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=TOL * scale, rtol=0,
                                   err_msg=name)


def test_mdn_sample_matches_jax(rng):
    """The likeliest component's mean, and a draw given JAX's Gumbel and
    normal draws (``jax.random.categorical`` is the Gumbel-max rule)."""
    logit = rng.standard_normal((2, 3, 7)).astype(np.float32)
    mean = rng.standard_normal((2, 3, 4, 7)).astype(np.float32)
    std = rng.uniform(0.5, 1.5, (2, 3, 4, 7)).astype(np.float32)
    key = jax.random.key(9)

    def jax_side(key):
        k1, k2 = jax.random.split(key)
        return ([jmdn.MixtureDensityNetworkLoss.sample(key, logit, mean, std, r)
                 for r in (False, True)],
                jax.random.gumbel(k1, (2, 7, 3)), jax.random.normal(k2, (2, 1, 4, 7)))

    wants, gumbel, z = jax.jit(jax_side)(key)
    for random, want in zip((False, True), wants):
        got = pmdn.MixtureDensityNetworkLoss.sample(
            torch.from_numpy(logit), torch.from_numpy(mean), torch.from_numpy(std), random,
            gumbel=torch.from_numpy(np.array(gumbel)), z=torch.from_numpy(np.array(z)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("inject", [False, True])
def test_finite_or_skip_matches_jax(rng, inject):
    """The signal MDN loss on an estimate with an inf injected: the term for
    the total is 0, the raw value is not finite, and the gradients (of the
    estimate and the head) are finite and equal JAX's; without the inf the
    term is the loss and the gradients are its own."""
    jl, pl, params = _mdn_pair(4, est_channels=4, tgt_channels=1, sampling_rate=1000,
                               sample_len_s=0.03, alpha_per_sample=True)
    est = rng.standard_normal((2, 30, 4)).astype(np.float32)
    if inject:
        est[1, 7, 2] = np.inf
    tgt = rng.standard_normal((2, 30, 1)).astype(np.float32)

    def term(p, e):
        return jax_finite_or_skip(lambda x: jl(p, x, tgt), e)

    (t_j, raw_j) = jax.jit(term)(params, est)
    g_p, g_e = jax.jit(jax.grad(lambda p, e: term(p, e)[0], argnums=(0, 1)))(params, est)
    e = torch.from_numpy(est).requires_grad_(True)
    t_p, raw_p = finite_or_skip(lambda x: pl(x, torch.from_numpy(tgt)), e)
    t_p.backward()
    assert bool(torch.isfinite(raw_p)) == (not inject) == bool(np.isfinite(raw_j))
    if inject:
        assert float(t_p) == float(t_j) == 0.0
    else:
        assert _rel(t_p.item(), float(t_j)) <= TOL and t_p.item() == raw_p.item()
    assert bool(torch.isfinite(e.grad).all()) and all(
        bool(torch.isfinite(p.grad).all()) for p in pl.parameters())
    _close_grads(pl, g_p, e.grad, g_e)


# ------------------------------------------------------------ the losses
@pytest.mark.parametrize("variant", ["plain", "with_noise_target", "dynamic_mixing"])
def test_compute_losses_matches_jax(variant, record_property):
    """``training_losses`` (dynamic mixing, normalisation, then
    ``compute_losses(train=True)``) on JAX's draws: the loss, the score,
    both MDN terms and the mean time within 1e-5 relative.  With
    ``with_noise_target`` the MDN targets hold the noise beside the target:
    2 signal channels, 2 x 16 mel channels."""
    extra = {"plain": [], "with_noise_target": ["+model.with_noise_target=true"],
             "dynamic_mixing": ["model.training.dynamic_mixing=true"]}[variant]
    jcfg, pcfg = config(*extra)
    jm = jregistry.instantiate(jcfg)
    params = jax.tree_util.tree_map(np.asarray, draw_params(jm, seed=8))
    batch = make_batch()
    key = jax.random.key(30)
    _, m = jax.jit(jm.training_losses)(params, key, batch["noisy"], batch["clean"])
    want = {k: float(v) for k, v in m.items()}
    model = port_model(pcfg, params)
    if variant == "with_noise_target":
        assert model.loss_signal.tgt_channels == 2 and model.loss_latent.tgt_channels == 32
    draws = torch_draws(loss_draws(key))
    if variant == "dynamic_mixing":
        assert draws["perm"].tolist() != list(range(B))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, got = model.training_losses(tb["noisy"], tb["clean"], draws=draws)
    worst = 0.0
    for k in ("train/loss", "train/score", "train/signal", "train/latent", "train/time_mean"):
        assert _rel(float(got[k]), want[k]) <= TOL, (k, float(got[k]), want[k])
        worst = max(worst, _rel(float(got[k]), want[k]))
    record_property("max_rel", worst)


# ------------------------------------------------------------ enhance
def test_enhance_at_the_universe_original_topology_matches_jax(monkeypatch,
                                                               record_property):
    """The experiment's model built for inference (no loss modules): the
    generic score path (SigmaBlock, no EDM), 3 steps, every ConvBlock
    through the fused chain's plain version (no weight norm: the convs
    count as folded); <= 2e-5."""
    jcfg, pcfg = config()
    jm = jregistry.instantiate(jcfg)
    params = {k: v for k, v in jax.tree_util.tree_map(
        np.asarray, draw_params(jm, seed=9)).items() if k in jm.model_param_keys()}
    model = pregistry.instantiate(pcfg)
    assert not model.loss_param_keys() and not model.with_edm
    assert from_jax_params(model, params) == []
    calls = []
    real = conv_block.fused_conv_chain_reference
    monkeypatch.setattr(conv_block, "fused_conv_chain_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    mix = (np.random.default_rng(3).standard_normal((B, 640)) * 0.1).astype(np.float32)
    key = jax.random.key(2)
    ref = np.asarray(jax.jit(lambda p, m: jm.enhance(p, m, key=key, n_steps=3, packed=False))(
        params, mix))
    out = model.enhance(mix, n_steps=3, noise=_jax_draws(key, (B, 648, 1), 3))
    # ConvBlocks: 6 per score pass (2 down, 2 up, the encoder's and the
    # decoder's extra block), 10 in the conditioner
    assert len(calls) == 6 * 3 + 10
    record_property("max_abs_diff", float(np.abs(out.numpy() - ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, atol=ENH_TOL, rtol=0)
