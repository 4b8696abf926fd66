"""The port's training losses and the enhancement family's base model
against the JAX package, at float32 on the CPU: ``MultiResL1SpecLoss``
(values and gradients), ``MultiLoss``, ``EnhancementBaseModel`` (losses,
dynamic mixing, validation losses, enhance) on a small wrapped network, the
registry's loss targets, and two UNIVERSE++ GAN steps with the auxiliary
loss on a warm-up schedule against ``make_gan_train_step``.

Weights are drawn with numpy into the JAX tree and carried over with
``from_jax_params``; random draws are JAX's, handed to the port.
"""
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from open_universe_tpu.configs import registry as jregistry  # noqa: E402
from open_universe_tpu.losses import MultiLoss as JMultiLoss  # noqa: E402
from open_universe_tpu.losses import MultiResL1SpecLoss as JMultiRes  # noqa: E402
from open_universe_tpu.models.enhancement import EnhancementBaseModel as JEnh  # noqa: E402
from open_universe_tpu.nn.layers import Conv1d as JConv1d  # noqa: E402
from open_universe_tpu.train import optim as joptim  # noqa: E402
from open_universe_tpu.train.steps import init_train_state, make_gan_train_step  # noqa: E402
from open_universe_tpu.train.trainer import _build_schedule  # noqa: E402
from open_universe_tpu_torch.configs import registry as pregistry  # noqa: E402
from open_universe_tpu_torch.losses import MultiLoss, MultiResL1SpecLoss  # noqa: E402
from open_universe_tpu_torch.models.enhancement import EnhancementBaseModel  # noqa: E402
from open_universe_tpu_torch.nn.layers import Conv1d  # noqa: E402
from open_universe_tpu_torch.train.trainer import make_gan_step  # noqa: E402
from open_universe_tpu_torch.utils.convert import from_jax_params  # noqa: E402
from test_torch_train import (  # noqa: E402
    B, MAX_STEPS, T, _capture, _check_deltas, _flat, _port_layout, _rel, draw_params,
    gan_config, step_draws,
)

LOSS_TARGET = "open_universe_tpu.losses.MultiResL1SpecLoss"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):  # numpy's BLAS too
        yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ MultiResL1SpecLoss
@pytest.mark.parametrize("windows", [[256], [64, 128, 512]])
@pytest.mark.parametrize("time_weight", [0.0, 0.5])
@pytest.mark.parametrize("scale_invariant", [False, True])
@pytest.mark.parametrize("channel_axis", [False, True])
def test_multires_l1_matches_jax(windows, time_weight, scale_invariant, channel_axis, rng,
                                 record_property):
    """The loss on (B, T) and (B, T, 1) inputs, several windows, the time
    term on and off, scale-invariant on and off: relative <= 1e-5.  Its
    gradient w.r.t. the estimate: <= 1e-3 of the largest, since an L1 on
    magnitudes flips its sign where |em - tm| rounds across 0 (the same
    reason the mel L1 of the GAN step needs a looser gradient bound)."""
    shape = (2, 1000, 1) if channel_axis else (2, 1000)
    est = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    tgt = (0.7 * est + rng.standard_normal(shape) * 0.05).astype(np.float32)
    kw = dict(window_sz=windows, time_domain_weight=time_weight,
              scale_invariant=scale_invariant)
    jl, pl = JMultiRes(**kw), MultiResL1SpecLoss(**kw)
    val_j, g_j = jax.value_and_grad(lambda e: jl(e, jnp.asarray(tgt)))(jnp.asarray(est))
    e = torch.from_numpy(est.copy()).requires_grad_(True)
    val_p = pl(e, torch.from_numpy(tgt))
    val_p.backward()
    assert _rel(float(val_p.detach()), float(val_j)) <= 1e-5
    g_j = np.asarray(g_j)
    err = np.abs(e.grad.numpy() - g_j).max() / np.abs(g_j).max()
    record_property("grad_rel", float(err))
    assert err <= 1e-3


def test_multiloss_and_registry_targets(rng):
    """MultiLoss (through the registry, as a config builds it) weighs its
    losses as the JAX package's does; both prefixes name the loss; the
    phoneme losses resolve (on an injected wav2vec2 model)."""
    node = {"_target_": "open_universe.losses.MultiLoss", "losses": {
        "a": [0.3, {"_target_": LOSS_TARGET, "window_sz": [128]}],
        "b": [2.0, {"_target_": "open_universe.losses.MultiResL1SpecLoss",
                    "window_sz": [64, 256], "time_domain_weight": 0.0}]}}
    pm, jm = pregistry.instantiate(node), jregistry.instantiate(node)
    assert isinstance(pm, MultiLoss) and isinstance(jm, JMultiLoss)
    est = (rng.standard_normal((2, 700)) * 0.1).astype(np.float32)
    tgt = (rng.standard_normal((2, 700)) * 0.1).astype(np.float32)
    tot_p, parts_p = pm(torch.from_numpy(est), torch.from_numpy(tgt), with_dict=True)
    tot_j, parts_j = jm(jnp.asarray(est), jnp.asarray(tgt), with_dict=True)
    assert _rel(float(tot_p), float(tot_j)) <= 1e-5
    for k in ("a", "b"):
        assert _rel(float(parts_p[k]), float(parts_j[k])) <= 1e-5
    import open_universe_tpu_torch.losses as plosses

    from open_universe_tpu_torch.nn.wav2vec2 import Wav2Vec2Config, Wav2Vec2ForCTC

    tiny = Wav2Vec2ForCTC(Wav2Vec2Config(
        hidden_size=8, num_hidden_layers=1, num_attention_heads=2, intermediate_size=8,
        conv_dim=(4,), conv_kernel=(10,), conv_stride=(5,), feat_extract_norm="layer",
        do_stable_layer_norm=True, num_conv_pos_embeddings=4, num_conv_pos_embedding_groups=2,
        vocab_size=6))
    assert type(pregistry.instantiate({"_target_": "open_universe.losses.PhonemeCTCLoss",
                                       "model": tiny})) is plosses.PhonemeCTCLoss


# ------------------------------------------------------------ EnhancementBaseModel
def _enh_pair(losses, training=None):
    """The same EnhancementBaseModel on a 5-tap valid conv (its output is 4
    samples short: forward's right pad) in JAX and in the port."""
    jnet = JConv1d(1, 1, 5)
    rng = np.random.default_rng(3)
    params = {"model": {"weight": (rng.uniform(-1, 1, (5, 1, 1)) * 0.6).astype(np.float32),
                        "bias": np.asarray([0.01], np.float32)}}
    kw = dict(fs=16000, losses=losses, training=training,
              normalization_kwargs={"ref": "both", "level_db": -26.0})
    jm = JEnh(model=jnet, **kw)
    pm = EnhancementBaseModel(model=Conv1d(1, 1, 5), **kw)
    assert from_jax_params(pm, params) == []
    return jm, jax.tree_util.tree_map(jnp.asarray, params), pm


def test_enhancement_base_model_matches_jax(rng):
    """Training losses with dynamic mixing (JAX's permutation handed over),
    validation losses (no mixing), a single-target losses node, a disabled
    loss, and enhance with keep_rms and the clip: relative <= 1e-5 (enhance
    <= 1e-5 of max|ref|)."""
    losses = {"l1": {"weight": 0.5, "kwargs": {"_target_": LOSS_TARGET,
                                               "window_sz": [64, 128]}},
              "off": None}
    jm, jp, pm = _enh_pair(losses, training={"dynamic_mixing": True})
    assert set(pm.losses_func) == {"l1"}
    clean = (rng.standard_normal((3, 900, 1)) * 0.1).astype(np.float32)
    noisy = (clean + rng.standard_normal(clean.shape) * 0.05).astype(np.float32)
    key = jax.random.key(7)
    perm = np.asarray(jax.random.permutation(key, 3))
    _, mj = jm.training_losses(jp, key, jnp.asarray(noisy), jnp.asarray(clean))
    with torch.no_grad():
        _, mp = pm.training_losses(torch.from_numpy(noisy), torch.from_numpy(clean),
                                   draws={"perm": torch.from_numpy(perm.copy())})
    _, vj = jm.validation_losses(jp, key, jnp.asarray(noisy), jnp.asarray(clean))
    with torch.no_grad():
        _, vp = pm.validation_losses(torch.from_numpy(noisy), torch.from_numpy(clean))
    assert set(mp) == set(mj) == {"train/main_loss", "train/l1"}
    assert set(vp) == set(vj) == {"val/main_loss", "val/l1"}
    for got, want in ((mp, mj), (vp, vj)):
        for k in want:
            assert _rel(float(got[k]), float(want[k])) <= 1e-5, k
    assert float(mp["train/l1"]) != float(vp["val/l1"])  # the mixing changed the batch

    single = {"_target_": LOSS_TARGET, "window_sz": [128]}
    jm1, jp1, pm1 = _enh_pair(single)
    _, m1j = jm1.training_losses(jp1, key, jnp.asarray(noisy), jnp.asarray(clean))
    with torch.no_grad():
        _, m1p = pm1.training_losses(torch.from_numpy(noisy), torch.from_numpy(clean))
    assert set(m1p) == set(m1j) == {"train/main_loss", "train/loss"}
    assert _rel(float(m1p["train/loss"]), float(m1j["train/loss"])) <= 1e-5

    for keep_rms in (False, True):
        for shape in ((900,), (3, 900)):
            x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
            ej = np.asarray(jm.enhance(jp, jnp.asarray(x), keep_rms=keep_rms))
            ep = pm.enhance(torch.from_numpy(x), keep_rms=keep_rms).numpy()
            assert ep.shape == ej.shape == shape
            np.testing.assert_allclose(ep, ej, atol=1e-5 * np.abs(ej).max(), rtol=0)


# ------------------------------------------------------------ aux loss in the GAN step
AUX = {"_target_": LOSS_TARGET, "window_sz": [64, 256], "time_domain_weight": 0.0}
AUX_SCHEDULE = {"start_step": 0, "warmup_steps": 2}
FREEZE = 5


def aux_config():
    """test_torch_train's UNIVERSE++ with two U-Net levels and no extra conv
    block (what the aux loss touches is the same; JAX compiles it in half
    the time), the aux loss and its schedule."""
    cfg = gan_config()
    for net in ("score_model", "condition_model"):
        cfg[net].update(rate_factors=[4, 5], extra_conv_block=False)
    cfg["losses"].update(aux_loss=AUX, aux_loss_schedule=AUX_SCHEDULE,
                         disc_freeze_step=FREEZE)
    cfg["losses"]["weights"]["aux"] = 3.0
    return cfg


def test_gan_steps_with_aux_loss_match_jax(record_property):
    """The disc-frozen GAN step (before ``disc_freeze_step``: the
    discriminators stay out, as in the trainer's warm-up phase) of UNIVERSE++
    with a MultiResL1SpecLoss aux loss (weight 3) on a warm-up schedule
    (start 0 over 2 steps), taken from the same weights at step 0 (aux
    weight 0) and at step 1 (0.5), against make_gan_train_step: the losses
    relative <= 1e-5 (``train/signal_aux`` 0, then the weighted aux loss),
    the port's ``train/aux_weight``; every gradient per tensor <= 1e-3 of its
    largest (1e-2 for a one-element PReLU slope, one sum over the batch)
    plus 1e-6 of its network's largest: the aux and mel losses are L1s, whose
    gradients flip sign where the two sides' magnitudes round apart, and a
    few tensors' gradients cancel to ~1e-7 of the network's (a conv's
    weight_g, PReLU slopes), where float32's summation order shows; every
    parameter's change as in test_torch_train."""
    cfg = aux_config()
    jm = jregistry.instantiate(cfg)
    assert jm.loss_aux is not None
    params = draw_params(jm)
    gen_keys = list(jm.model_param_keys())
    from open_universe_tpu.nn.module import buffer_mask

    mask = buffer_mask(jm, params)
    optimized = set(jm.optimized_param_keys())
    gen_mask = {k: mask[k] if k in optimized else jax.tree_util.tree_map(lambda _: False, mask[k])
                for k in gen_keys}
    sch = cfg["scheduler"]
    tx = optax.chain(_capture(), joptim.adamw(
        _build_schedule(sch["generator"], 2e-4, MAX_STEPS, gan_role="generator",
                        freeze_step=FREEZE),
        betas=(0.8, 0.99), weight_decay=0.01, weight_decay_exclude=("prelu", "bias"),
        params={k: params[k] for k in gen_keys}, trainable_mask=gen_mask))
    tx_disc = joptim.adamw(_build_schedule(sch["discriminator"], 2e-4, MAX_STEPS,
                                           gan_role="discriminator", freeze_step=FREEZE),
                           betas=(0.8, 0.99), weight_decay=0.01)
    step_j = jax.jit(make_gan_train_step(jm, tx, tx_disc, disc_frozen=True,
                                         grad_clip_vals=cfg["optimizer"]["grad_clip_vals"]))
    rng = np.random.default_rng(1)
    clean = (rng.standard_normal((B, T, 1)) * 0.05).astype(np.float32)
    batch = {"clean": clean,
             "noisy": clean + (rng.standard_normal((B, T, 1)) * 0.02).astype(np.float32)}
    key = jax.random.key(20)
    state0 = init_train_state(jm, params, tx, disc_tx=tx_disc)
    params = jax.tree_util.tree_map(np.asarray, params)
    worst_loss, worst_grad, flips = 0.0, {}, 0
    for at in (0, 1):
        state, m = step_j(dict(state0, step=jnp.asarray(at, jnp.int32)), batch, key)
        want = {k: float(v) for k, v in m.items()}
        assert (want["train/signal_aux"] > 0.0) == bool(at)

        model = pregistry.instantiate_trainable(cfg)
        assert isinstance(model.loss_aux, MultiResL1SpecLoss)
        assert from_jax_params(model, params) == []
        step_p = make_gan_step(model, MAX_STEPS)
        step_p.step = at
        got = {k: float(v) for k, v in step_p(
            {k: torch.from_numpy(v) for k, v in batch.items()},
            draws={k: torch.from_numpy(v.copy()) for k, v in step_draws(key).items()},
            disc_frozen=True).items()}
        assert got.pop("train/aux_weight") == [0.0, 0.5][at]
        assert set(got) == set(want)
        for k, v in want.items():
            if k.startswith("train/"):
                assert _rel(got[k], v) <= 1e-5 or abs(got[k] - v) <= 1e-9, (at, k)
                worst_loss = max(worst_loss, _rel(got[k], v) if v else 0.0)

        p0 = _port_layout(model, _flat(params))
        p1 = _port_layout(model, _flat(jax.tree_util.tree_map(np.asarray, state["params"])))
        g = _port_layout(model, _flat(jax.tree_util.tree_map(np.asarray, state["opt_state"][0])))
        nets = ("score_model.", "condition_model.")
        net_scale = {net: max(np.abs(g[n]).max() for n in g if n.startswith(net)) for net in nets}
        for name, p in model.named_parameters():
            if not name.startswith(nets):
                continue
            scale = np.abs(g[name]).max()
            err = np.abs(p.grad.numpy() - g[name]).max()
            net = net_scale[name.split(".")[0] + "."]
            floor = 1e-6 * net
            assert err <= (1e-2 if p.numel() == 1 else 1e-3) * scale + floor, (at, name, err)
            worst_grad[at] = max(worst_grad.get(at, 0.0), float(err / (scale + floor)))
            # AdamW's first step moves an element by about +-lr whatever its
            # gradient's size: one whose gradient is within 1e-4 of the
            # network's largest (where the gradient bound above is loose)
            # counts as small-gradient, held to 2 lr
            g_check = np.where(np.abs(g[name]) < 1e-4 * net, 0.0, g[name])
            d_port, d_jax = p.detach().numpy() - p0[name], p1[name] - p0[name]
            if not np.abs(d_jax).max() > 0:  # no gradient, no decay: no move
                assert not d_port.any(), (at, name)
                continue
            n_small, _ = _check_deltas(name, p0[name], d_port, d_jax, g_check, 2e-4)
            flips += n_small
    n = sum(p.numel() for p in model.parameters())
    record_property("losses_max_rel", worst_loss)
    record_property("grad_rel_max_by_step", worst_grad)
    record_property("small_gradient_elements_over_bound", flips)
    assert flips <= 1e-3 * n
