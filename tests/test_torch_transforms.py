"""The PyTorch port's transforms against the JAX package's, at float32 on the
CPU: ``istft``, ``denormalize_batch``, ``CompressedMagSTFT`` (every
transform type, both ways, and its padded variant), the networks'
``precoding`` and ``Universe.enhance`` with a ``CompressedMagSTFT``
transform.

The narrow networks take 8 channels: the transform's 2 x 4 frequency bins
(n_fft 6).  The conditioner's mel front-end hops by rate factors x input
channels samples, so the transform hops by 8 and a frame lines up with a
sample of the mel's hop at every level.  Bounds: 1e-5 of max|ref| for the
transforms (both ways), the networks and ``istft``; 2e-5 for ``enhance``,
the sampler-golden bound of PARITY.md.
"""
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from open_universe_tpu.models import transforms as jtransforms  # noqa: E402
from open_universe_tpu.models.condition import ConditionerNetwork as JaxCond  # noqa: E402
from open_universe_tpu.models.score import ScoreNetwork as JaxScore  # noqa: E402
from open_universe_tpu.models.universe import Universe as JaxUniverse  # noqa: E402
from open_universe_tpu.ops import istft as jax_istft  # noqa: E402
from open_universe_tpu.utils import norm as jnorm  # noqa: E402
from open_universe_tpu_torch.configs import registry as pregistry  # noqa: E402
from open_universe_tpu_torch.models import transforms as ptransforms  # noqa: E402
from open_universe_tpu_torch.models.condition import ConditionerNetwork  # noqa: E402
from open_universe_tpu_torch.models.score import ScoreNetwork  # noqa: E402
from open_universe_tpu_torch.models.universe import IdentityTransform, Universe  # noqa: E402
from open_universe_tpu_torch.ops.stft import istft  # noqa: E402
from open_universe_tpu_torch.utils import norm as pnorm  # noqa: E402
from open_universe_tpu_torch.utils.convert import from_jax_params  # noqa: E402
from test_torch_enhance import _jax_draws  # noqa: E402

TOL = 1e-5
ENH_TOL = 2e-5
B, T, N_STEPS = 2, 640, 3
STFT = {"n_fft": 6, "hop_length": 8, "window_name": "hann"}
SPEC = {"transform_type": "exponent", "abs_exponent": 0.5, "factor": 0.3}
_NET = dict(rate_factors=[2, 2], n_channels=8, use_weight_norm=False)
_SCORE = dict(_NET, noise_cond_dim=32, input_channels=8, output_channels=8)
_COND = dict(_NET, n_mels=16, n_mel_oversample=4, input_channels=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    more oversubscribe the cores the other test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):  # numpy's BLAS too
        yield
    torch.set_num_threads(n)


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= tol * np.abs(b).max(), (err, np.abs(b).max())
    return err


def _draw(tree_shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 1.0 / np.sqrt(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 0.5
        return (rng.uniform(-1.0, 1.0, s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, tree_shapes)


def _shapes(module):
    return jax.eval_shape(module.init, jax.random.key(0))


@pytest.mark.parametrize("n_fft,hop,length", [(16, 4, None), (16, 4, 70), (15, 5, 120),
                                              (32, 8, 200), (6, 8, None)])
def test_istft_matches_jax(rng, n_fft, hop, length, record_property):
    """Hann and Hamming windows; ``length`` shorter than the overlap-added
    signal, longer (zero-padded) and none (the symmetric trim); a hop
    longer than the window (parts of the signal no frame covers)."""
    n_freq = n_fft // 2 + 1
    z = (rng.standard_normal((2, 3, 19, n_freq))
         + 1j * rng.standard_normal((2, 3, 19, n_freq))).astype(np.complex64)
    for window in (None, ptransforms.get_window("hamming", n_fft)):
        jw = None if window is None else jnp.asarray(window.numpy())
        want = jax.jit(lambda z: jax_istft(z, n_fft, hop, length=length, window=jw))(z)
        got = istft(torch.from_numpy(z), n_fft, hop, length=length, window=window)
        record_property(f"max_abs_{'hann' if window is None else 'hamming'}",
                        _close(got, want))


def test_denormalize_batch_matches_jax(rng):
    """``normalize_batch`` then ``denormalize_batch`` of its statistics, both
    references, on both sides: <= 1e-5 of max|ref|, and back to the mix."""
    mix = (rng.standard_normal((3, 500, 1)) * 0.2 + 0.05).astype(np.float32)
    tgt = (rng.standard_normal((3, 500, 1)) * 0.1).astype(np.float32)
    for ref in ("noisy", "both"):
        (jm, _), jmean, jstd = jnorm.normalize_batch((jnp.asarray(mix), jnp.asarray(tgt)),
                                                     norm=2, level_db=-26.0, ref=ref)
        (pm, _), pmean, pstd = pnorm.normalize_batch(
            (torch.from_numpy(mix), torch.from_numpy(tgt)), norm=2, level_db=-26.0, ref=ref)
        want = jnorm.denormalize_batch(jm * 0.5, jmean, jstd)
        _close(pnorm.denormalize_batch(pm * 0.5, pmean, pstd), want)
        _close(pnorm.denormalize_batch(pm, pmean, pstd), mix)


_SPECS = {
    "exponent": ({"n_fft": 32, "hop_length": 8, "window_name": "hann"},
                 {"transform_type": "exponent", "abs_exponent": 0.5, "factor": 0.3}),
    "exponent_1": ({"n_fft": 32, "hop_length": 8, "window_name": "hamming"},
                   {"transform_type": "exponent", "abs_exponent": 1, "factor": 0.3}),
    "log": ({"n_fft": 32, "hop_length": 8, "window_name": "sqrthann"},
            {"transform_type": "log", "abs_exponent": 1.0, "factor": 1.0}),
    "none": ({"n_fft": 30, "hop_length": 10, "window_name": "hann"},
             {"transform_type": "none", "abs_exponent": 1.0, "factor": 1.0}),
}


@pytest.mark.parametrize("case", list(_SPECS))
@pytest.mark.parametrize("padded", [False, True])
def test_compressed_mag_stft_matches_jax(rng, case, padded, record_property):
    """Forward (B, T, 1) -> (B, frames, 2 n_freq), inverse with and without
    ``length``, and the ``inv`` flag that swaps the two; the padded variant
    pads to ``pad_block`` twice and cuts a hop each time, as the reference
    does, and its inverse defaults to frames x hop samples."""
    stft_kw, spec_kw = _SPECS[case]
    extra = {"pad_block": 4 * stft_kw["hop_length"]} if padded else {}
    jcls = jtransforms.CompressedMagSTFTPadded if padded else jtransforms.CompressedMagSTFT
    pcls = ptransforms.CompressedMagSTFTPadded if padded else ptransforms.CompressedMagSTFT
    jt, pt = jcls(dict(stft_kw), dict(spec_kw), **extra), pcls(dict(stft_kw), dict(spec_kw),
                                                                **extra)
    x = (rng.standard_normal((2, 301, 1)) * 0.3).astype(np.float32)
    want = jax.jit(lambda x: jt({}, x))(x)
    got = pt(torch.from_numpy(x))
    record_property("forward_max_abs", _close(got, want))
    for length in (None, 290):
        want_b = jax.jit(lambda z: jt.inv({}, z, length=length))(want)
        got_b = pt.inv(got, length=length)
        record_property(f"inverse_{length}_max_abs", _close(got_b, want_b))
    pinv = pcls(dict(stft_kw), dict(spec_kw), inv=True, **extra)
    torch.testing.assert_close(pinv(got), pt.inv(got), rtol=0, atol=0)
    torch.testing.assert_close(pinv(torch.from_numpy(x), inv=True), got, rtol=0, atol=0)


def test_transforms_registered_under_both_prefixes():
    for prefix in ("open_universe.", "open_universe_tpu."):
        for name, extra in (("CompressedMagSTFT", {}),
                            ("CompressedMagSTFTPadded", {"pad_block": 32})):
            tr = pregistry.instantiate({"_target_": f"{prefix}layers.dyn_range_comp.{name}",
                                        "stft_kwargs": STFT, "spec_kwargs": SPEC, **extra})
            assert type(tr).__name__ == name and not list(tr.parameters())
        assert isinstance(pregistry.instantiate(
            {"_target_": f"{prefix}layers.dyn_range_comp.IdentityTransform"}),
            IdentityTransform)


def _pair(jmod, pmod, seed):
    params = _draw(_shapes(jmod), seed)
    assert from_jax_params(pmod, params) == []
    return params


def test_precoding_in_both_networks_matches_jax(rng, record_property):
    """The conditioner and the score network with a CompressedMagSTFT
    precoding (the networks run on the transform of their input and give
    back a waveform): conditions, auxiliary signal, latent and score."""
    def precoding(pkg):
        return pkg.CompressedMagSTFT(dict(STFT), dict(SPEC))

    jc = JaxCond(**_COND, output_channels=8, precoding=precoding(jtransforms))
    pc = ConditionerNetwork(**_COND, output_channels=8, precoding=precoding(ptransforms))
    js = JaxScore(**_SCORE, precoding=precoding(jtransforms))
    ps = ScoreNetwork(**_SCORE, precoding=precoding(ptransforms))
    cparams, sparams = _pair(jc, pc, 1), _pair(js, ps, 2)
    t = 648  # 82 frames: 41, then 21 at the bottleneck, as the mel's 21
    x = (rng.standard_normal((B, t, 1)) * 0.3).astype(np.float32)
    sigma = np.array([0.3, 1.7], np.float32)

    def jax_fwd(cp, sp, x, sigma):
        cond, y_hat, h = jc(cp, x, train=True)
        return cond, y_hat, h, js(sp, x * 0.5, sigma, cond)

    cond_j, y_j, h_j, s_j = jax.jit(jax_fwd)(cparams, sparams, x, sigma)
    with torch.no_grad():
        cond_p, y_p, h_p = pc(torch.from_numpy(x))
        s_p = ps(torch.from_numpy(x) * 0.5, torch.from_numpy(sigma), cond_p)
    assert y_p.shape == (B, t, 1) and s_p.shape == (B, t, 1)
    for a, b in zip(cond_p, cond_j):
        _close(a, b)
    _close(h_p, h_j)
    record_property("aux_max_abs", _close(y_p, y_j))
    record_property("score_max_abs", _close(s_p, s_j))


def test_enhance_with_a_transform_matches_jax(monkeypatch, record_property):
    """``Universe.enhance`` with a CompressedMagSTFT transform: the sampler
    runs on (B, 81, 8) spectrogram frames of the padded 644-sample mix,
    and the fake-score probe against the transformed target; <= 2e-5."""
    from open_universe_tpu_torch.ops.kernels import conv_block

    kw = dict(fs=16000, normalization_norm=2,
              normalization_kwargs={"ref": "both", "level_db": -26.0},
              diffusion={"schedule": "geometric", "sigma_min": 5e-4, "sigma_max": 5.0,
                         "n_steps": N_STEPS, "epsilon": 1.3})
    jm = JaxUniverse(score_model=JaxScore(**_SCORE), condition_model=JaxCond(**_COND),
                     transform=jtransforms.CompressedMagSTFT(dict(STFT), dict(SPEC)),
                     losses={"weights": {"score": 1.0}}, **kw)
    params = {k: _draw(_shapes(getattr(jm, k)), seed=i)
              for i, k in enumerate(jm.model_param_keys())}
    pm = Universe(score_model=ScoreNetwork(**_SCORE),
                  condition_model=ConditionerNetwork(**_COND),
                  transform=ptransforms.CompressedMagSTFT(dict(STFT), dict(SPEC)), **kw)
    assert from_jax_params(pm, params) == []
    calls = []
    real = conv_block.fused_conv_chain_reference
    monkeypatch.setattr(conv_block, "fused_conv_chain_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(3)
    mix = (rng.standard_normal((B, T)) * 0.1).astype(np.float32)
    target = (0.5 * mix + 0.01 * rng.standard_normal((B, T))).astype(np.float32)
    key = jax.random.key(5)
    frames = (B, 81, 8)
    for tgt in (None, target):
        ref = np.asarray(jax.jit(lambda p, m, tg: jm.enhance(
            p, m, key=key, n_steps=N_STEPS, packed=False, target=tg))(params, mix, tgt))
        calls.clear()
        out = pm.enhance(mix, n_steps=N_STEPS, target=tgt,
                         noise=_jax_draws(key, frames, N_STEPS, probe=tgt is not None))
        assert out.shape == (B, T) and bool(torch.isfinite(out).all())
        # ConvBlocks: 4 per score pass, 8 in the conditioner (the mel
        # adapter's, 2 down, 2 around the GRU, the decoder's input and 2 up)
        assert len(calls) == (4 * N_STEPS + 8 if tgt is None else 8)
        record_property(f"max_abs_diff_{'probe' if tgt is not None else 'score'}",
                        float(np.abs(out.numpy() - ref).max()))
        np.testing.assert_allclose(out.numpy(), ref, atol=ENH_TOL, rtol=0)
