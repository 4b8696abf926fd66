"""The PyTorch port's modules against their JAX counterparts, at float32 on
the CPU: ops, layers (weight-norm unfolded and folded), blocks, the snake
activations and their resampler, sigma embeddings, the two networks,
normalisation, the ensemble signal median, and the weight carry-over.

Inputs and weights are made with numpy from a seed; the weights enter the
JAX param tree and reach the port through ``from_jax_params``.  Bound: 1e-5.
"""
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from open_universe_tpu import nn as jnn  # noqa: E402
from open_universe_tpu import ops as jops  # noqa: E402
from open_universe_tpu.inference.torch_convert import (  # noqa: E402
    fold_weight_norm as jax_fold,
    to_torch_state_dict,
)
from open_universe_tpu.models import condition as jcond  # noqa: E402
from open_universe_tpu.models import score as jscore  # noqa: E402
from open_universe_tpu.models.presets import universepp as jax_universepp  # noqa: E402
from open_universe_tpu.utils import normalize_batch as jax_normalize  # noqa: E402
from open_universe_tpu.utils import signal_median as jax_signal_median  # noqa: E402
from open_universe_tpu_torch.models import condition as pcond  # noqa: E402
from open_universe_tpu_torch.models import score as pscore  # noqa: E402
from open_universe_tpu_torch.models.presets import universepp as port_universepp  # noqa: E402
from open_universe_tpu_torch.nn import blocks as pblocks  # noqa: E402
from open_universe_tpu_torch.nn import layers as players  # noqa: E402
from open_universe_tpu_torch.nn import sigma as psigma  # noqa: E402
from open_universe_tpu_torch.nn import snake as psnake  # noqa: E402
from open_universe_tpu_torch.ops import conv as pconv  # noqa: E402
from open_universe_tpu_torch.ops import stft as pstft  # noqa: E402
from open_universe_tpu_torch.utils.convert import (  # noqa: E402
    fold_weight_norm,
    from_jax_params,
)
from open_universe_tpu_torch.utils import stats as pstats  # noqa: E402
from open_universe_tpu_torch.utils.norm import normalize_batch  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    more oversubscribe the cores the other test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):  # numpy's BLAS too
        yield
    torch.set_num_threads(n)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().numpy()
    return np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=0)


def jax_params(jax_mod, seed=0):
    """A param tree of ``jax_mod``'s structure, drawn with numpy (JAX's own
    eager init compiles every leaf shape and takes tens of seconds on a CPU):
    uniform, scaled by 1/sqrt(fan_in) for matrices and conv kernels."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_mod.init, jax.random.key(0))

    def draw(s):
        scale = 1.0 / np.sqrt(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 0.5
        return (rng.uniform(-1.0, 1.0, s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _pair(jax_mod, port_mod, fold=False, seed=0):
    """Params for ``jax_mod`` (folded or not), carried into ``port_mod``."""
    params = jax_params(jax_mod, seed)
    if fold:
        params = jax.jit(lambda p: jax_fold(jax_mod, p))(params)
        if "weight_v" in params:  # a leaf layer: jax_fold walks children only
            params = {"weight": jax_mod.weight(params),
                      **({"bias": params["bias"]} if "bias" in params else {})}
        fold_weight_norm(port_mod)
    params = jax.tree_util.tree_map(np.asarray, params)
    assert from_jax_params(port_mod, params) == []
    return params


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- ops/conv.py
@pytest.mark.parametrize("k,stride,padding,groups", [
    (4, 1, "same", 1), (5, 1, "same", 1), (5, 5, 0, 1), (3, 3, 0, 2), (1, 1, 0, 1),
])
def test_conv1d(rng, k, stride, padding, groups):
    x = _x(rng, 2, 41, 6)
    w = _x(rng, k, 6 // groups, 4)      # JAX (K, Cin/g, Cout)
    b = _x(rng, 4)
    ref = jops.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      stride=stride, padding=padding, groups=groups)
    out = pconv.conv1d(torch.from_numpy(x), torch.from_numpy(w.transpose(2, 1, 0).copy()),
                       torch.from_numpy(b), stride=stride, padding=padding,
                       groups=groups)
    _close(out, ref)


@pytest.mark.parametrize("k,stride", [(2, 2), (4, 4), (5, 5), (3, 2)])
def test_conv_transpose1d(rng, k, stride):
    x = _x(rng, 2, 13, 6)
    w = _x(rng, k, 6, 4)                # JAX (K, Cin, Cout), taps flipped
    b = _x(rng, 4)
    ref = jops.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                stride=stride)
    out = pconv.conv_transpose1d(
        torch.from_numpy(x), torch.from_numpy(w[::-1].transpose(1, 2, 0).copy()),
        torch.from_numpy(b), stride=stride)
    _close(out, ref)


def test_depthwise_and_linear(rng):
    x = _x(rng, 2, 30, 5)
    kern = _x(rng, 6)
    _close(pconv.depthwise_conv1d_same(torch.from_numpy(x), torch.from_numpy(kern)),
           jops.depthwise_conv1d_same(jnp.asarray(x), jnp.asarray(kern)))
    w, b = _x(rng, 5, 7), _x(rng, 7)
    _close(pconv.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                        torch.from_numpy(b)),
           jops.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


# ---------------------------------------------------------------- ops/stft.py
@pytest.mark.parametrize("n_fft,hop,power", [(32, 8, 2.0), (20, 6, 1.0), (16, 16, 0.5)])
def test_spectrogram(rng, n_fft, hop, power):
    x = _x(rng, 3, 200) * 0.05
    x[0] = 0.0  # an all-zero row exercises the 1e-30 clamp at power 0.5
    _close(pstft.frame(torch.from_numpy(x), n_fft, hop),
           jops.frame(jnp.asarray(x), n_fft, hop))
    z_p = pstft.stft(torch.from_numpy(x), n_fft, hop)
    z_j = jops.stft(jnp.asarray(x), n_fft, hop)
    _close(z_p.real, np.real(z_j))
    _close(z_p.imag, np.imag(z_j))
    _close(pstft.spectrogram(torch.from_numpy(x), n_fft, hop, power=power),
           jops.spectrogram(jnp.asarray(x), n_fft, hop, power=power))


def test_mel_filterbank_and_window():
    _close(pstft.mel_filterbank(129, 80, 24000), jops.mel_filterbank(129, 80, 24000))
    _close(pstft.hann_window(64), jops.hann_window(64))


# ------------------------------------------------------------- nn/layers.py
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("kind", ["conv", "conv_transpose", "linear"])
def test_weighted_layers(rng, kind, fold):
    if kind == "conv":
        args, kw = (6, 4, 3), dict(stride=2, weight_norm=True)
        jmod, pmod = jnn.Conv1d(*args, **kw), players.Conv1d(*args, **kw)
        x = _x(rng, 2, 21, 6)
    elif kind == "conv_transpose":
        args, kw = (6, 4, 4), dict(stride=4, weight_norm=True)
        jmod, pmod = jnn.ConvTranspose1d(*args, **kw), players.ConvTranspose1d(*args, **kw)
        x = _x(rng, 2, 9, 6)
    else:
        jmod, pmod = jnn.Linear(6, 5, weight_norm=True), players.Linear(6, 5, weight_norm=True)
        x = _x(rng, 3, 6)
    params = _pair(jmod, pmod, fold=fold)
    assert pmod.folded == fold
    with torch.no_grad():
        _close(pmod(torch.from_numpy(x)), jmod(params, jnp.asarray(x)))


@pytest.mark.parametrize("n", [1, 6])
def test_prelu(rng, n):
    jmod, pmod = jnn.PReLU(n), players.PReLU(n)
    params = _pair(jmod, pmod)
    params["weight"] = _x(rng, n)
    from_jax_params(pmod, params)
    x = _x(rng, 2, 7, 6)
    with torch.no_grad():
        _close(pmod(torch.from_numpy(x)), jmod(params, jnp.asarray(x)))


def test_gru(rng):
    jmod, pmod = jnn.GRU(6, 5, num_layers=2), players.GRU(6, 5, num_layers=2)
    params = _pair(jmod, pmod)
    x = _x(rng, 2, 11, 6)
    with torch.no_grad():
        _close(pmod(torch.from_numpy(x)), jmod(params, jnp.asarray(x)))


# -------------------------------------------------------------- nn/snake.py
@pytest.mark.parametrize("orig,new,t", [(1, 2, 37), (2, 1, 74), (2, 1, 73), (3, 2, 20)])
def test_resample(rng, orig, new, t):
    x = _x(rng, 2, t, 3)
    _close(psnake.resample(torch.from_numpy(x), orig, new),
           jnn.resample(jnp.asarray(x), orig, new))


def test_resample_up_and_down(rng):
    """1 -> 2 -> 1, the anti-aliased activation's sandwich without the
    activation: the port's and JAX's agree at each stage."""
    x = _x(rng, 2, 41, 3)
    up_p = psnake.resample(torch.from_numpy(x), 1, 2)
    up_j = jnn.resample(jnp.asarray(x), 1, 2)
    _close(up_p, up_j)
    _close(psnake.resample(up_p, 2, 1), jnn.resample(up_j, 2, 1))


@pytest.mark.parametrize("logscale,beta", [(False, False), (True, False), (True, True)])
def test_snake(rng, logscale, beta):
    for jmod, pmod in ((jnn.Snake(5, alpha_logscale=logscale, beta=beta),
                        psnake.Snake(5, alpha_logscale=logscale, beta=beta)),
                       (jnn.AliasFreeSnake(5, alpha_logscale=logscale, beta=beta),
                        psnake.AliasFreeSnake(5, alpha_logscale=logscale, beta=beta))):
        params = _pair(jmod, pmod)
        x = _x(rng, 2, 29, 5)
        with torch.no_grad():
            _close(pmod(torch.from_numpy(x)), jmod(params, jnp.asarray(x)))
    assert list(dict(pmod.named_parameters())) == (
        ["act.act.alpha", "act.act.beta"] if beta else ["act.act.alpha"])


# -------------------------------------------------------------- nn/sigma.py
def test_sigma_embeddings(rng):
    log_sigma = _x(rng, 3)
    for jmod, pmod in ((jnn.SimpleTimeEmbedding(16), psigma.SimpleTimeEmbedding(16)),
                       (jnn.SigmaBlock(8, 32), psigma.SigmaBlock(8, 32))):
        params = _pair(jmod, pmod)
        if "weight" in params:  # make the learned frequency non-trivial
            params = {"weight": _x(rng, 1, 1), "bias": _x(rng, 1, 1)}
            from_jax_params(pmod, params)
        with torch.no_grad():
            _close(pmod(torch.from_numpy(log_sigma)),
                   jmod(params, jnp.asarray(log_sigma)))


# -------------------------------------------------------------- nn/blocks.py
def test_film_and_binomial(rng):
    x, y = _x(rng, 2, 9, 4), _x(rng, 2, 8)
    _close(pblocks.film(torch.from_numpy(x), torch.from_numpy(y)),
           jnn.film(jnp.asarray(x), jnp.asarray(y)))
    for k in (3, 9, 11):
        _close(pblocks.binomial_filter(k), jnn.binomial_filter(k))
    x = _x(rng, 2, 30, 3)
    _close(pblocks.BinomialAntiAlias(9)(torch.from_numpy(x)),
           jnn.BinomialAntiAlias(9)({}, jnp.asarray(x)))


@pytest.mark.parametrize("transpose,antialiasing,t", [
    (False, True, 23), (False, False, 24), (True, True, 7), (True, False, 7),
])
def test_prelu_conv(rng, transpose, antialiasing, t):
    kw = dict(stride=4, use_transpose=transpose, weight_norm=True,
              antialiasing=antialiasing)
    jmod, pmod = jnn.PReLUConv(6, 4, 4, **kw), pblocks.PReLUConv(6, 4, 4, **kw)
    params = _pair(jmod, pmod)
    if antialiasing:
        params["bias"] = _x(rng, 4)  # the manual bias, after the low-pass
        from_jax_params(pmod, params)
    x = _x(rng, 2, t, 6)
    with torch.no_grad():
        _close(pmod(torch.from_numpy(x)), jmod(params, jnp.asarray(x)))


@pytest.mark.parametrize("act", ["snake", "snakebeta"])
def test_snake_prelu_conv(rng, act):
    """The signal-decoupling layer's shape: C -> 1, 3 taps, 'same'."""
    jmod = jnn.PReLUConv(6, 1, 3, padding="same", act_type=act)
    pmod = pblocks.PReLUConv(6, 1, 3, padding="same", act_type=act)
    params = _pair(jmod, pmod)
    x = _x(rng, 2, 37, 6)
    with torch.no_grad():
        out = pmod(torch.from_numpy(x))
    assert out.shape == (2, 37, 1)
    _close(out, jmod(params, jnp.asarray(x)))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("direction,t,length", [
    ("down", 27, None),   # stride remainder pads v before the rate conv
    ("up", 7, 27),        # up-length repair: pad one sample, then crop
    ("up", 7, 30),        # ... or pad the output to the length
    ("none", 11, None),
])
def test_conv_block(rng, direction, t, length, fold):
    c = 8
    kw = dict(rate_change=4 if direction != "none" else None,
              rate_change_dir=direction, weight_norm=True,
              antialiasing=direction != "none")
    jmod, pmod = jnn.ConvBlock(c, **kw), pblocks.ConvBlock(c, **kw)
    params = _pair(jmod, pmod, fold=fold)
    cin = 2 * c if direction == "up" else c
    h = _x(rng, 2, t, cin)
    nc = _x(rng, 2, 2 * c)
    t_out = length if direction == "up" else t
    ic = _x(rng, 2, t_out, c) if direction == "up" else None
    res = _x(rng, 2, t_out, c) if direction == "up" else None
    ref = jax.jit(lambda p, *a: jmod(p, *a, length=length))(
        params, jnp.asarray(h), jnp.asarray(nc),
        None if ic is None else jnp.asarray(ic),
        None if res is None else jnp.asarray(res))
    assert pmod._fused_eligible() is False  # autograd is on, no scope
    with torch.no_grad():
        assert pmod._fused_eligible() is fold
        out = pmod(torch.from_numpy(h), noise_cond=torch.from_numpy(nc),
                   input_cond=None if ic is None else torch.from_numpy(ic),
                   res=None if res is None else torch.from_numpy(res),
                   length=length)
    for o, r in zip(out, ref):
        _close(o, r)


# ------------------------------------------------------------------ networks
_TINY = dict(rate_factors=[2, 4], n_channels=8, extra_conv_block=True,
             use_weight_norm=True)


@pytest.mark.parametrize("fold", [False, True])
def test_score_network(rng, fold):
    kw = dict(_TINY, noise_cond_dim=32, use_antialiasing=True,
              time_embedding="simple")
    jmod, pmod = jscore.ScoreNetwork(**kw), pscore.ScoreNetwork(**kw)
    params = _pair(jmod, pmod, fold=fold)
    x, sigma = _x(rng, 2, 64, 1), np.array([0.3, 2.0], np.float32)
    cond = [_x(rng, 2, 64 // r, c) for r, c in ((8, 32), (2, 16), (1, 8))]
    ref = jax.jit(jmod.apply)(params, jnp.asarray(x), jnp.asarray(sigma),
                              [jnp.asarray(c) for c in cond])
    with torch.no_grad():
        out = pmod(torch.from_numpy(x), torch.from_numpy(sigma),
                   [torch.from_numpy(c) for c in cond])
    _close(out, ref)


@pytest.mark.parametrize("fold", [False, True])
def test_conditioner_network(rng, fold):
    assert pcond._st_conv_rates([2, 4, 4, 5]) == jcond._st_conv_rates([2, 4, 4, 5])
    assert pcond.MelAdapter.CLAIMED_SAMPLE_RATE == 24000
    kw = dict(_TINY, n_mels=16, n_mel_oversample=4, encoder_gru_residual=True,
              use_antialiasing=True)
    jmod, pmod = jcond.ConditionerNetwork(**kw), pcond.ConditionerNetwork(**kw)
    params = _pair(jmod, pmod, fold=fold)
    x = _x(rng, 2, 72, 1) * 0.1
    conds, y_hat, h = jax.jit(lambda p, a: jmod(p, a, train=True))(
        params, jnp.asarray(x))
    with torch.no_grad():
        p_conds, p_y, p_h = pmod(torch.from_numpy(x))
    assert len(p_conds) == len(conds) == 3
    for a, b in zip(p_conds, conds):
        _close(a, b)
    _close(p_y, y_hat)
    _close(p_h, h)


# ------------------------------------------------------------ utils/norm.py
@pytest.mark.parametrize("norm,ref", [(2, "both"), ("max", "noisy"), ("2-max", "both")])
def test_normalize_batch(rng, norm, ref):
    mix, tgt = _x(rng, 3, 50, 1), _x(rng, 3, 50, 1)
    (m_j, t_j), mean_j, std_j = jax_normalize((jnp.asarray(mix), jnp.asarray(tgt)),
                                              norm=norm, level_db=-26.0, ref=ref)
    (m_p, t_p), mean_p, std_p = normalize_batch(
        (torch.from_numpy(mix), torch.from_numpy(tgt)), norm=norm, level_db=-26.0,
        ref=ref)
    for a, b in ((m_p, m_j), (t_p, t_j), (mean_p, mean_j), (std_p, std_j)):
        _close(a, b)


# ----------------------------------------------------------- utils/stats.py
@pytest.mark.parametrize("n", [4, 5])
def test_signal_median(rng, n):
    """An even and an odd ensemble, with ties in the ranks (repeated values)
    and in the count of median positions (two members win as often)."""
    x = np.round(_x(rng, n, 3, 40, 1) * 2) / 2  # few distinct values: ties
    x[:, 2] = 0.0  # every member equal: the stable sort's order decides
    tie = np.zeros((n, 1, 4, 1), np.float32)
    tie[:, 0, :, 0] = np.arange(n)[:, None] * np.array([1, 1, -1, -1])
    for sig in (x, tie):
        _close(pstats.signal_median(torch.from_numpy(sig)),
               jax_signal_median(jnp.asarray(sig)))


# ----------------------------------------------------------- utils/convert.py
def test_from_jax_params_matches_torch_export():
    """The carried-over state_dict equals the JAX package's own export to the
    reference torch layout, on the whole UNIVERSE++ 16 kHz generator tree
    (the signal-decoupling layer included)."""
    jm = jax_universepp(16000)
    params = {"score_model": jax_params(jm.score_model),
              "condition_model": jax_params(jm.condition_model, seed=1),
              "signal_decoupling_layer": jax_params(jm.signal_decoupling_layer,
                                                    seed=2)}
    export = to_torch_state_dict(jm, params)
    pm = port_universepp(16000, device="cpu")
    assert from_jax_params(pm, params) == []
    state = pm.state_dict()
    assert sorted(state) == sorted(export)
    for k, v in export.items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)


def test_universepp_24k_preset_matches_config_and_jax_tree(monkeypatch):
    """``universepp(24000)`` has the state_dict (keys and shapes) of the
    registry's build of config/model/universepp_24k.yaml, and takes the JAX
    24 kHz preset's param tree (its shapes, from ``jax.eval_shape``)
    strictly.  The structure is what is held here, so the preset's seeded
    draw of its ~107M weights is skipped."""
    import pathlib

    import yaml

    from open_universe_tpu_torch.configs.registry import instantiate
    from open_universe_tpu_torch.models import presets

    node = yaml.safe_load((pathlib.Path(__file__).parents[1] / "config" / "model"
                           / "universepp_24k.yaml").read_text())
    for k, v in node["condition_model"].items():  # ${model.score_model.<k>}
        if isinstance(v, str) and v.startswith("${model.score_model."):
            node["condition_model"][k] = node["score_model"][v[20:-1]]
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in instantiate(node).state_dict().items()}
    monkeypatch.setattr(presets, "init_weights", lambda model, seed: model)
    pm = presets.universepp(24000, device="cpu")
    assert {k: tuple(v.shape) for k, v in pm.state_dict().items()} == want
    jm = jax_universepp(24000)
    params = {name: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(getattr(jm, name).init, jax.random.key(0)))
        for name in jm.model_param_keys()}
    assert from_jax_params(pm, params) == []
    widths = sorted({m.conv1.out_channels for m in pm.modules()
                     if isinstance(m, pblocks.ConvBlock)})
    assert widths == [48, 96, 192, 384, 768] and pm.tot_ds == 240


@pytest.mark.parametrize("norm", ["weight_norm", "spectral_norm"])
def test_conv2d(rng, norm):
    """The discriminators' layer: NCHW here, NHWC in JAX; spectral norm with
    JAX's power iterations from its fixed start vector; <= 1e-5 x max|ref|."""
    from open_universe_tpu.nn.layers import Conv2d as JaxConv2d

    kw = {norm: True}
    jmod = JaxConv2d(3, 6, (5, 3), stride=(3, 1), padding=(2, 1), **kw)
    pmod = players.Conv2d(3, 6, (5, 3), stride=(3, 1), padding=(2, 1), **kw)
    params = _pair(jmod, pmod)
    x = _x(rng, 2, 17, 4, 3)  # NHWC
    ref = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        out = pmod(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).permute(0, 2, 3, 1)
    _close(out, ref, tol=1e-5 * np.abs(ref).max())


# ------------------------------------------- fused eligibility (ConvBlock)
class _CudaLike:
    """What ``_fused_eligible`` reads of a CUDA tensor: device, dtype, shape."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype, self.requires_grad = shape, dtype, False
        self.device = torch.device("cuda")


@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, (2, 5, 32)), (torch.bfloat16, (2, 5, 768)),
    (torch.float16, (2, 5, 32)),   # no route
    (torch.float32, (2, 5, 40)),   # no width
    (torch.float32, (2, 5, 16)),
    (torch.float32, (65536, 1, 32)),  # batch beyond the grid
])
def test_fused_eligibility_refuses_what_the_kernel_refuses(dtype, shape):
    """On the card a block takes the kernel only where the wrapper's checks
    pass (dtype in ROUTES, C in WIDTHS, 1 <= B <= 65535); elsewhere it runs
    the unfused chain, as JAX's fused_conv_chain returns None.  A CPU tensor
    runs the plain version, which takes any of them."""
    from open_universe_tpu_torch.ops.kernels import conv_block

    c = shape[-1]
    block = pblocks.ConvBlock(c)
    fold_weight_norm(block)
    for p in block.parameters():
        p.requires_grad_(False)
    h = torch.zeros(shape, dtype=dtype)
    chain = block._chain_args(torch.float32)
    try:
        conv_block._check(h, tuple(w.to(dtype) if w.dim() > 1 or i % 3 == 1 else w
                                   for i, w in enumerate(chain)), None, None)
        kernel_takes = True
    except (TypeError, ValueError):
        kernel_takes = False
    with torch.no_grad():
        assert block._fused_eligible(_CudaLike(shape, dtype)) is kernel_takes
        assert block._fused_eligible(h) is True
    assert kernel_takes is (shape in ((2, 5, 32), (2, 5, 768)) and dtype != torch.float16)


@pytest.mark.parametrize("fold", [False, True])
def test_fused_eligibility_refuses_what_needs_a_gradient(rng, fold):
    """Inside inference_scope with autograd on, a block whose parameters or
    input need gradients (a conv without weight norm counts as folded) runs
    the unfused chain: its weight gradients are non-zero and equal the
    unfused chain's.  Without anything needing a gradient it takes the
    kernel's path."""
    from open_universe_tpu_torch.ops import kernels

    c = 8
    block = pblocks.ConvBlock(c, weight_norm=not fold)
    players.init_weights(block, seed=0)
    h, nc = torch.from_numpy(_x(rng, 2, 21, c)), torch.from_numpy(_x(rng, 2, 2 * c))
    grads = []
    for enabled in (True, False):
        kernels.enable(enabled)
        try:
            with kernels.inference_scope():
                assert block._fused_eligible(h) is False
                v, _, cond = block(h, noise_cond=nc)
                (v.sum() + cond.square().sum()).backward()
        finally:
            kernels.enable(True)
        grads.append({n: p.grad.clone() for n, p in block.named_parameters()})
        block.zero_grad()
    for n, g in grads[0].items():
        assert g.abs().max() > 0, n
        torch.testing.assert_close(g, grads[1][n], rtol=0, atol=0)
    with kernels.inference_scope():
        h_in = h.clone().requires_grad_(True)
        for p in block.parameters():
            p.requires_grad_(False)
        assert block._fused_eligible(h_in) is False
        assert block._fused_eligible(h) is fold
