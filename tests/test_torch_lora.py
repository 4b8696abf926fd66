"""LoRA fine-tuning in the PyTorch port against the JAX package, at float32
on the CPU: the adapters (``lora_delta``, ``inject``, ``remove`` on Conv1d,
ConvTranspose1d and Linear), the trainable set against JAX's mask,
``UniverseLoRA``'s gradient-gated unrolled sampler, its losses and their
adapter gradients with n_steps_backprop 1 and (with the frozen
discriminators' loss) 2, one ``TrainStep`` against ``make_train_step``, ``merge_lora`` and the
fused kernel's gate, and partial diffusion.

The tiny UNIVERSE++ of ``test_checkpoint_conversion.TINY_GAN_CFG`` (as JAX's
``tests/test_lora.py`` uses): its weights and the adapters are drawn with
numpy into the port's model and carried to the JAX package by its own
``convert_state_dict`` (the path a reference checkpoint takes); JAX's
``inject`` runs under ``eval_shape`` (no draws, the same tree structure,
its modules marked), and the random draws of the sampler are JAX's, handed
to the port.  Each JAX step is compiled once for the module.
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
from open_universe_tpu.inference.torch_convert import convert_state_dict  # noqa: E402
from open_universe_tpu.models.universe_lora import UniverseLoRA as JLoRA  # noqa: E402
from open_universe_tpu.nn import layers as jlayers  # noqa: E402
from open_universe_tpu.nn import lora as jlora  # noqa: E402
from open_universe_tpu.nn.module import buffer_mask  # noqa: E402
from open_universe_tpu.train import optim as joptim  # noqa: E402
from open_universe_tpu.train.steps import init_train_state, make_train_step  # noqa: E402
from open_universe_tpu_torch.configs import registry as pregistry  # noqa: E402
from open_universe_tpu_torch.models.universe_lora import UniverseLoRA  # noqa: E402
from open_universe_tpu_torch.nn import layers as players  # noqa: E402
from open_universe_tpu_torch.nn import lora as plora  # noqa: E402
from open_universe_tpu_torch.nn.layers import init_weights  # noqa: E402
from open_universe_tpu_torch.ops.kernels import conv_block  # noqa: E402
from open_universe_tpu_torch.train import trainer as ptrainer  # noqa: E402
from open_universe_tpu_torch.utils.convert import (  # noqa: E402
    _to_port_layout, fold_weight_norm, from_jax_params,
)
from test_checkpoint_conversion import TINY_GAN_CFG  # noqa: E402
from test_torch_train import _capture, _check_deltas, _flat, _rel  # noqa: E402

FS, B, T = 16000, 2, 800
N_STEPS, RANK, ALPHA, LR = 2, 2, 4.0, 1e-3
LOSSES = {"multires_l1": {"weight": 0.1, "kwargs": {
    "_target_": "open_universe_tpu.losses.MultiResL1SpecLoss",
    "window_sz": [64, 256], "time_domain_weight": 0.0}}, "phonemeloss": None}


def lora_kwargs(n_steps_backprop, **kw):
    return {**dict(fs=FS, losses=LOSSES, training={"audio_len": T / FS, "ema_decay": 0.999},
                   diffusion={"n_steps": N_STEPS, "epsilon": 1.3},
                   n_steps_backprop=n_steps_backprop, lora_rank=RANK, lora_alpha=ALPHA,
                   use_hifigan_loss=True, weight_hifigan_loss=0.01,
                   optimizer={"lr": LR, "weight_decay": 1e-4},
                   grad_clipper={"_target_": "open_universe_tpu.train.optim.FixedClipper",
                                 "max_norm": 1000.0}), **kw}


def _has_lora(module):
    return any(isinstance(m, plora.LoraLayer) for m in module.modules())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):  # numpy's BLAS too
        yield
    torch.set_num_threads(n)


@torch.no_grad()
def _draw(module, seed, only=None):
    """Every parameter of ``module`` (or those whose name holds ``only``)
    drawn with numpy: uniform, scaled by 1/sqrt(fan_in), 0.3 for vectors."""
    rng = np.random.default_rng(seed)
    for name, p in module.named_parameters():
        if only is None or only in name:
            scale = 1.0 / np.sqrt(np.prod(p.shape[1:])) if p.dim() > 1 else 0.3
            p.copy_(torch.from_numpy((rng.uniform(-1, 1, p.shape) * scale).astype(np.float32)))
    return module


def _port_base():
    """The tiny UNIVERSE++ (discriminators included), weight norm folded, on
    numpy weights."""
    return _draw(fold_weight_norm(init_weights(pregistry.instantiate_trainable(
        copy.deepcopy(TINY_GAN_CFG)), 0)), seed=1)


def _jax_lora(jm, port_lora, nb, **kw):
    """JAX's UniverseLoRA on ``jm`` and the port model's weights: the JAX
    package's inject traced (it marks the modules and gives the tree's
    structure), then its convert_state_dict of the port's state_dict."""
    jl = JLoRA(model=jm, **lora_kwargs(nb, **kw))
    params, skipped = convert_state_dict(jl, port_lora.state_dict())
    assert not [k for k in skipped if "lora" in k or k.startswith("model.score")]
    for sub, seed in (("score_model", 0), ("condition_model", 1)):
        base = {k: v for k, v in params["model"][sub].items()}
        shapes = jax.eval_shape(lambda p: jlora.inject(getattr(jm, sub), _unlora(p), RANK,
                                                       ALPHA, key=jax.random.key(seed)), base)
        assert _structure(shapes) == _structure(params["model"][sub]), sub
    # a copy: the converted leaves are views of the port's parameters, and
    # jnp.asarray of a numpy array may share its memory on the CPU
    return jl, jax.tree_util.tree_map(lambda v: jnp.asarray(np.array(v, copy=True)), params)


def _unlora(tree):
    """A LoRA tree with its adapters removed (the base tree inject takes)."""
    if not isinstance(tree, dict):
        return tree
    for nest, a in (("conv", "lora_weight_a"), ("linear", "lora_linear_a")):
        if a in tree:
            return tree[nest]
    return {k: _unlora(v) for k, v in tree.items()}


def _structure(tree):
    return {k: _structure(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def _port_lora(base, nb, **kw):
    m = UniverseLoRA(model=copy.deepcopy(base), **lora_kwargs(nb, **kw))
    return _draw(m, seed=2, only="lora_")  # adapters away from A @ B = 0


def lora_draws(key, shape, n_steps=N_STEPS):
    """UniverseLoRA.forward's draws for ``key``: the initial one, then one
    per loop step, as its key chain splits them."""
    key, k0 = jax.random.split(key)
    out = [jax.random.normal(k0, shape)]
    for _ in range(n_steps - 1):
        key, ks = jax.random.split(key)
        out.append(jax.random.normal(ks, shape))
    return [torch.from_numpy(np.asarray(z).copy()) for z in out]


def _batch():
    rng = np.random.default_rng(5)
    clean = (rng.standard_normal((B, T, 1)) * 0.05).astype(np.float32)
    return {"clean": clean,
            "noisy": clean + (rng.standard_normal((B, T, 1)) * 0.02).astype(np.float32)}


PAD_SHAPE = (B, T + 160 - T % 160, 1)  # the padded mix (total downsampling 160)


@pytest.fixture(scope="module")
def setup():
    base = _port_base()
    jm = jregistry.instantiate(copy.deepcopy(TINY_GAN_CFG))
    out = {"base": base, "jm": jm, "batch": _batch()}
    # n_steps_backprop 1 without the discriminators' loss (a smaller JAX
    # program), 2 with it
    for nb in (1, 2):
        pl = _port_lora(base, nb, use_hifigan_loss=nb == 2)
        jl, jp = _jax_lora(jm, pl, nb, use_hifigan_loss=nb == 2)
        out[nb] = (pl, jl, jp)
    return out


# ------------------------------------------------------------------ adapters
def _layer_pairs():
    return [(jlayers.Conv1d(6, 8, 3, padding="same"), players.Conv1d(6, 8, 3, padding="same"),
             (2, 20, 6)),
            (jlayers.ConvTranspose1d(8, 6, 4, stride=2, padding=1),
             players.ConvTranspose1d(8, 6, 4, stride=2, padding=1), (2, 10, 8)),
            (jlayers.Linear(6, 5), players.Linear(6, 5), (3, 6))]


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["Conv1d", "ConvTranspose1d", "Linear"])
def test_lora_delta_inject_remove_match_jax(kind, rng):
    """inject: the identity at init (the port and JAX, and each against the
    base); a bumped adapter (A for a conv, B for a linear: the one that
    starts at zero) changes the output as JAX's does; lora_delta in the
    port's layout and remove's merged weight against JAX's; the merged
    layer's output equals the adapter's: all <= 1e-6 of max|ref|."""
    jl, pl, shape = _layer_pairs()[kind]
    jp = jax.tree_util.tree_map(np.asarray, jl.init(jax.random.key(kind)))
    assert from_jax_params(pl, jp) == []
    x = rng.standard_normal(shape).astype(np.float32)
    y_base = pl(torch.from_numpy(x)).detach().numpy()

    jpl = jlora.inject(jl, jp, rank=RANK, alpha=ALPHA, key=jax.random.key(3))
    holder = torch.nn.Module()
    holder.layer = pl
    plora.inject(holder, RANK, ALPHA)
    wrapped = holder.layer
    assert isinstance(wrapped, plora.LoraLayer)
    nest, a_key, b_key = jlora.adapter_names(jl)
    assert (wrapped.nest, wrapped.a_name, wrapped.b_name) == (nest, a_key, b_key)
    jpl = jax.tree_util.tree_map(np.asarray, jpl)
    np.testing.assert_allclose(wrapped(torch.from_numpy(x)).detach().numpy(), y_base,
                               atol=1e-6 * np.abs(y_base).max(), rtol=0)
    np.testing.assert_allclose(np.asarray(jl(jpl, jnp.asarray(x))), y_base,
                               atol=1e-6 * np.abs(y_base).max(), rtol=0)
    bump = b_key if nest == "linear" else a_key
    jpl[bump] = (rng.standard_normal(jpl[bump].shape) * 0.3).astype(np.float32)
    assert from_jax_params(wrapped, jpl) == []
    y_j = np.asarray(jl(jpl, jnp.asarray(x)))
    y_p = wrapped(torch.from_numpy(x)).detach().numpy()
    assert not np.allclose(y_j, y_base)
    np.testing.assert_allclose(y_p, y_j, atol=1e-6 * np.abs(y_j).max(), rtol=0)
    d_j = _to_port_layout(wrapped.base, "weight", np.asarray(jlora.lora_delta(jl, jpl)))
    np.testing.assert_allclose(wrapped.delta().detach().numpy(), d_j,
                               atol=1e-6 * np.abs(d_j).max(), rtol=0)

    merged_j = jlora.remove(jl, jpl)
    plora.remove(holder)
    assert type(holder.layer) is type(pl) and not _has_lora(holder)
    w_j = _to_port_layout(pl, "weight", np.asarray(merged_j["weight"]))
    np.testing.assert_allclose(pl.weight.detach().numpy(), w_j, atol=1e-6 * np.abs(w_j).max(),
                               rtol=0)
    np.testing.assert_allclose(holder.layer(torch.from_numpy(x)).detach().numpy(), y_j,
                               atol=1e-6 * np.abs(y_j).max(), rtol=0)


def test_inject_skips_and_remove_refuses_weight_norm():
    """A layer whose min(cin // groups, cout) is below the rank keeps no
    adapter (JAX's rule); remove raises on a weight-normed base."""
    holder = torch.nn.Module()
    holder.narrow = players.Conv1d(8, 1, 3)
    holder.grouped = players.Conv1d(8, 8, 3, groups=8)
    holder.wide = players.Conv1d(8, 8, 3, weight_norm=True)
    plora.inject(holder, 2)
    assert isinstance(holder.wide, plora.LoraLayer)
    assert not isinstance(holder.narrow, plora.LoraLayer)
    assert not isinstance(holder.grouped, plora.LoraLayer)
    for jl in (jlayers.Conv1d(8, 1, 3), jlayers.Conv1d(8, 8, 3, groups=8)):
        p = jl.init(jax.random.key(0))
        assert "lora_weight_a" not in jlora.inject(jl, p, 2)
    with pytest.raises(ValueError, match="weight norm"):
        plora.remove(holder)


@pytest.mark.parametrize("train_biases,names", [(True, ()), (False, ()),
                                                (False, ("input_conv",))])
def test_trainable_set_matches_jax_mask(setup, train_biases, names):
    """The parameters that require a gradient are the True leaves of JAX's
    trainable mask, name for name (the kept MPD/MRD biases among them when
    biases train, as JAX's mask walks the whole ``model`` tree)."""
    pl = _port_lora(setup["base"], 1, lora_train_biases=train_biases,
                    lora_train_names=names)
    jl, jp = _jax_lora(setup["jm"], pl, 1)
    mask = _flat(jlora.trainable_mask_lora(jp, train_biases=train_biases, train_names=names))
    want = {k for k, v in mask.items() if bool(v)}
    got = {n for n, p in pl.named_parameters() if p.requires_grad}
    assert got == want
    assert got == set(pl.trainable)
    assert any(n.startswith("model.loss_mpd.") for n in got) == train_biases
    assert set(_flat(jax.tree_util.tree_map(np.asarray, jp))) == set(pl.state_dict())


# ------------------------------------------------------------------ the sampler
@pytest.fixture(scope="module")
def grads_nb1(setup):
    """JAX's training_losses, its gradients and forward's output with
    n_steps_backprop 1 (no discriminators' loss), jitted once."""
    pl, jl, jp = setup[1]
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    key = jax.random.key(11)
    k_fwd, _ = jax.random.split(key)

    def run(p):
        (loss, metrics), grads = jax.value_and_grad(
            lambda q: jl.training_losses(q, key, batch["noisy"], batch["clean"]),
            has_aux=True)(p)
        (mix, _), *_ = jl.normalize_batch((batch["noisy"], batch["clean"]))
        return metrics, grads, jl.forward(p, mix[:, :, 0], key=k_fwd, n_steps=N_STEPS)

    metrics, grads, enh = jax.jit(run)(jp)
    return {"key": key, "k_fwd": k_fwd, "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _flat(jax.tree_util.tree_map(np.asarray, grads)),
            "enh": np.asarray(enh)}


def _check_grads(pl, want, record_property):
    """Every trainable tensor's gradient against JAX's: per tensor max|d| <=
    1e-3 max|g| + 1e-6 of the largest adapter gradient.  The losses are L1s
    (the STFT magnitudes' and the discriminators' feature maps'), whose
    gradients flip sign where the two sides round apart; a tensor whose
    gradient cancels to ~1e-7 of the largest shows float32's summation
    order."""
    top = max(np.abs(want[n]).max() for n in pl.trainable)
    worst = {}
    for n in pl.trainable:
        p = dict(pl.named_parameters())[n]
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        err = np.abs(g - want[n]).max()
        bound = 1e-3 * np.abs(want[n]).max() + 1e-6 * top
        assert err <= bound, (n, err, bound)
        worst[n] = float(err / bound)
    assert max(np.abs(want[n]).max() for n in pl.trainable if "lora_" in n) > 0
    record_property("grad_err_over_bound_max", max(worst.values()))
    return worst


def test_forward_and_gradients_nb1_match_jax(setup, grads_nb1, record_property):
    """n_steps_backprop 1 (the first loop step under no_grad, the final score
    evaluation with gradients; the multi-resolution loss alone): forward on JAX's draws within 2e-5 (the
    sampler's result is ~5e-2 here; its relative difference is recorded);
    training_losses' every term relative <= 1e-5; every trainable gradient
    (adapters, biases, the kept discriminators' biases) as _check_grads."""
    pl, _, _ = setup[1]
    run = grads_nb1
    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    (mix, _), *_ = pl.normalize_batch((batch["noisy"], batch["clean"]))
    with torch.no_grad():
        enh = pl(mix[:, :, 0], noise=lora_draws(run["k_fwd"], PAD_SHAPE)).numpy()
    assert enh.shape == (B, T)
    np.testing.assert_allclose(enh, run["enh"], atol=2e-5, rtol=0)
    record_property("forward_rel", float(np.abs(enh - run["enh"]).max()
                                         / np.abs(run["enh"]).max()))
    for p in pl.parameters():
        p.grad = None
    loss, metrics = pl.training_losses(batch["noisy"], batch["clean"],
                                       draws={"noise": lora_draws(run["k_fwd"], PAD_SHAPE)})
    loss.backward()
    assert set(metrics) == set(run["metrics"])
    for k, v in run["metrics"].items():
        assert _rel(float(metrics[k].detach()), v) <= 1e-5, k
    _check_grads(pl, run["grads"], record_property)


# ------------------------------------------------------------------ the train step
@pytest.fixture(scope="module")
def step_nb2(setup):
    """One step of JAX's make_train_step with n_steps_backprop 2, as JAX's
    trainer builds it (AdamW on buffer_mask & the LoRA mask, constant lr,
    FixedClipper, EMA of ("model",)); its gradients captured."""
    pl, jl, jp = setup[2]
    mask = buffer_mask(jl, jp)
    tmask = jl.trainable_mask(jp)
    mask = jax.tree_util.tree_map(lambda a, b: bool(a) and bool(b), mask, tmask)
    tx = optax.chain(_capture(), joptim.adamw(
        LR, betas=(0.8, 0.99), weight_decay=1e-4, weight_decay_exclude=("prelu", "bias"),
        params=jp, trainable_mask=mask))
    clipper = joptim.FixedClipper(1000.0)
    state0 = init_train_state(jl, jp, tx, clipper=clipper)
    key = jax.random.key(12)
    state, metrics = jax.jit(make_train_step(jl, tx, clipper=clipper))(
        state0, {k: jnp.asarray(v) for k, v in setup["batch"].items()}, key)
    grads = _flat(jax.tree_util.tree_map(np.asarray, state["opt_state"][0]))
    return {"key": key, "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "mask": _flat(mask),
            "p0": _flat(jax.tree_util.tree_map(np.asarray, jp)),
            "p1": _flat(jax.tree_util.tree_map(np.asarray, state["params"])),
            "ema": _flat(jax.tree_util.tree_map(np.asarray, state["ema"]["shadow"]))}


def test_train_step_nb2_matches_jax(setup, step_nb2, record_property):
    """One TrainStep (make_train_step of the port's trainer: AdamW over the
    trainable set, FixedClipper, EMA) with n_steps_backprop 2 (the loop
    step and the final score evaluation with gradients) against JAX's
    make_train_step: the losses relative <= 1e-5; grad/norm against the
    norm of JAX's gradients over the trainable set (JAX's own grad/norm
    also counts the frozen ones' gradients: the port follows the reference);
    every trainable gradient as _check_grads; every change and EMA shadow
    as test_torch_train's _check_deltas; the frozen weights unchanged, bit
    for bit."""
    pl, _, _ = setup[2]
    run = step_nb2
    frozen = {n: p.detach().clone() for n, p in pl.named_parameters() if not p.requires_grad}
    step = ptrainer.make_train_step(pl, 100)
    key = run["key"]
    k_fwd, _ = jax.random.split(key)  # training_losses' split
    m = step({k: torch.from_numpy(v) for k, v in setup["batch"].items()},
             draws={"noise": lora_draws(k_fwd, PAD_SHAPE)})
    got = {k: float(v) for k, v in m.items()}
    for k, v in run["metrics"].items():
        if k.startswith("train/"):
            assert _rel(got[k], v) <= 1e-5, k
    norm = np.sqrt(sum(float(np.sum(np.square(run["grads"][n].astype(np.float64))))
                       for n, on in run["mask"].items() if on))
    assert _rel(got["grad/norm"], norm) <= 1e-4
    assert run["metrics"]["grad/norm"] > norm  # JAX counts the frozen gradients too
    _check_grads(pl, run["grads"], record_property)
    flips = 0
    for n, p in pl.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p.detach(), frozen[n]), n
            np.testing.assert_array_equal(run["p1"][n], run["p0"][n])
            continue
        d_jax = run["p1"][n] - run["p0"][n]
        if not np.abs(d_jax).max() > 0:
            assert not (p.detach().numpy() - run["p0"][n]).any(), n
            continue
        n_small, _ = _check_deltas(n, run["p0"][n], p.detach().numpy() - run["p0"][n], d_jax,
                                   run["grads"][n], LR)
        n_shadow, _ = _check_deltas(n + " (EMA)", run["p0"][n],
                                    step.ema.shadow[n].numpy() - run["p0"][n],
                                    run["ema"][n] - run["p0"][n], run["grads"][n], LR)
        flips += n_small + n_shadow
    n_el = sum(p.numel() for p in pl.parameters() if p.requires_grad)
    record_property("small_gradient_elements_over_bound", flips)
    assert flips <= 1e-2 * n_el


# ------------------------------------------------------------------ merge and the gate
def _count_wrappers(monkeypatch):
    calls = []
    for name in ("fused_conv_chain", "fused_conv_chain_rows"):
        real = getattr(conv_block, name)
        monkeypatch.setattr(conv_block, name,
                            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    return calls


def test_merge_lora_and_the_kernel_gate(setup, monkeypatch, record_property):
    """With adapters attached the fused chain's wrappers (which on the CPU
    run the plain version) are called 0 times: in a training step with
    lora_train_biases False (every chain weight frozen), in the sampler
    under no_grad, and in enhance.  merge_lora gives a plain Universe whose
    8-step enhance calls the main one 94 times (10 per score pass, 14 in the
    conditioner), the rows entry never, and equals the adapter model's
    enhance on the same draws within 1e-4 (JAX's own bound for its merge);
    the adapter model is left as it was."""
    calls = _count_wrappers(monkeypatch)
    pl = _port_lora(setup["base"], 1, lora_train_biases=False)
    assert not any(p.requires_grad for n, p in pl.named_parameters() if "lora_" not in n)
    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    loss, _ = pl.training_losses(batch["noisy"], batch["clean"],
                                 generator=torch.Generator().manual_seed(0))
    loss.backward()
    with torch.no_grad():
        pl(batch["noisy"][:, :, 0], generator=torch.Generator().manual_seed(0))
    mix = batch["noisy"][:, :, 0]
    noise = [torch.randn(PAD_SHAPE, generator=torch.Generator().manual_seed(i))
             for i in range(8)]
    out_adapter = pl.enhance(mix, n_steps=8, noise=noise)
    assert not calls
    merged = pl.merge_lora()
    assert type(merged).__name__ == "UniverseGAN" and not _has_lora(merged)
    assert getattr(merged, "loss_mpd", None) is None and _has_lora(pl)
    out_merged = merged.enhance(mix, n_steps=8, noise=noise)
    assert len(calls) == 94 and set(calls) == {"fused_conv_chain"}
    err = (out_merged - out_adapter).abs().max().item()
    record_property("merged_vs_adapter", err)
    assert err <= 1e-4
    assert torch.equal(pl.enhance(mix, n_steps=8, noise=noise), out_adapter)


def test_partial_diffusion_and_random_steps(setup):
    """Partial diffusion (a start time per sample, as JAX tests it): the
    output's shape and finiteness, with gradients reaching the adapters;
    partial_diffusion_random_steps raises as in JAX; n_steps_backprop 0
    raises."""
    pl = _port_lora(setup["base"], 1, use_partial_diffusion=True)
    mix = torch.from_numpy(setup["batch"]["noisy"][:, :, 0])
    out = pl(mix, generator=torch.Generator().manual_seed(3))
    assert out.shape == (B, T) and bool(torch.isfinite(out).all())
    out.square().mean().backward()
    assert any(p.grad is not None and p.grad.abs().max() > 0
               for n, p in pl.named_parameters() if "lora_" in n)
    with pytest.raises(NotImplementedError, match="partial_diffusion_random_steps"):
        _port_lora(setup["base"], 1, partial_diffusion_random_steps=True)
    with pytest.raises(NotImplementedError, match="partial_diffusion_random_steps"):
        JLoRA(model=setup["jm"], **lora_kwargs(1, partial_diffusion_random_steps=True))
    with pytest.raises(ValueError, match="n_steps_backprop"):
        _port_lora(setup["base"], 0)
