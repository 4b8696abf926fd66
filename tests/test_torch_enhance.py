"""The PyTorch port's ``Universe.enhance`` against the JAX package's, on the
CPU at float32, given the same weights and the same noise draws.

Small config of both packages' classes: rate factors [2, 4], 8 channels,
batch 2, 640 samples, 3 steps.  The EDM fast path and the generic score path
run with weight norm folded on both sides (the port's ConvBlocks then take
the fused kernel's plain version) and unfolded (the unfused chain).  The
rest of ``enhance`` runs on the same networks in UNIVERSE++ (with the snake
signal-decoupling layer): ensembles (mean, median of an even and an odd
ensemble, signal_median, with keep_rms), warm start, ``use_aux_signal`` and
the fake-score probe (``target``).  Bound: 2e-5, the sampler-golden bound of
PARITY.md.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from open_universe_tpu.inference.torch_convert import (  # noqa: E402
    fold_weight_norm as jax_fold,
)
from open_universe_tpu.models.condition import ConditionerNetwork as JaxCond  # noqa: E402
from open_universe_tpu.models.score import ScoreNetwork as JaxScore  # noqa: E402
from open_universe_tpu.models.universe import Universe as JaxUniverse  # noqa: E402
from open_universe_tpu.models.universe_gan import UniverseGAN as JaxUniverseGAN  # noqa: E402
from open_universe_tpu_torch.models.condition import ConditionerNetwork  # noqa: E402
from open_universe_tpu_torch.models.score import ScoreNetwork  # noqa: E402
from open_universe_tpu_torch.models.universe import Universe  # noqa: E402
from open_universe_tpu_torch.models.universe_gan import UniverseGAN  # noqa: E402
from open_universe_tpu_torch.ops.kernels import conv_block  # noqa: E402
from open_universe_tpu_torch.utils.convert import (  # noqa: E402
    fold_weight_norm,
    from_jax_params,
)

TOL = 2e-5
B, T, N_STEPS = 2, 640, 3
T_PADDED = 648  # Universe.pad adds a full period (8) to a multiple of 8

_SCORE = dict(rate_factors=[2, 4], n_channels=8, noise_cond_dim=32,
              extra_conv_block=True, use_weight_norm=True, use_antialiasing=True,
              time_embedding="simple")
_COND = dict(rate_factors=[2, 4], n_channels=8, n_mels=16, n_mel_oversample=4,
             encoder_gru_residual=True, extra_conv_block=True,
             use_weight_norm=True)
# ConvBlock calls per enhance: 6 per score pass, 10 in the conditioner
CHAIN_CALLS = 6 * N_STEPS + 10


def _universe_kwargs(edm):
    return dict(fs=16000, normalization_norm=2,
                normalization_kwargs={"ref": "both", "level_db": -26.0},
                diffusion={"schedule": "geometric", "sigma_min": 5e-4,
                           "sigma_max": 5.0, "n_steps": N_STEPS, "epsilon": 1.3},
                edm={"noise": 0.25} if edm else None)


def _jax_params(model, seed=0):
    """Numpy-drawn weights in the JAX tree's structure (uniform, scaled by
    1/sqrt(fan_in))."""
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 1.0 / np.sqrt(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 0.5
        return (rng.uniform(-1.0, 1.0, s.shape) * scale).astype(np.float32)

    key = jax.random.key(0)
    return {name: jax.tree_util.tree_map(
                draw, jax.eval_shape(getattr(model, name).init, key))
            for name in model.model_param_keys()}


def _jax_noise(key, n_loop):
    """JAX's draws (models/universe.py:565-577,608): the initial one, then
    the step-i draw from step_keys[n_loop + i]."""
    shape = (B, T_PADDED, 1)
    k_init, k_loop = jax.random.split(key)
    step_keys = jax.random.split(k_loop, 2 * n_loop + 1)
    return [np.array(jax.random.normal(k_init, shape))] + [
        np.array(jax.random.normal(step_keys[n_loop + i], shape))
        for i in range(n_loop)]


@pytest.mark.parametrize("edm,fold", [(True, True), (False, True), (True, False)])
def test_enhance_matches_jax(monkeypatch, record_property, edm, fold):
    jm = JaxUniverse(score_model=JaxScore(**_SCORE),
                     condition_model=JaxCond(**_COND),
                     losses={"weights": {"score": 1.0}}, **_universe_kwargs(edm))
    params = _jax_params(jm)
    if fold:
        params = jax.tree_util.tree_map(
            np.asarray, jax.jit(lambda p: jax_fold(jm, p))(params))
    mix = np.random.default_rng(1).standard_normal((B, T)).astype(np.float32) * 0.1
    key = jax.random.key(1)
    ref = np.asarray(jax.jit(lambda p, m: jm.enhance(
        p, m, key=key, n_steps=N_STEPS, packed=False))(params, jnp.asarray(mix)))

    pm = Universe(score_model=ScoreNetwork(**_SCORE),
                  condition_model=ConditionerNetwork(**_COND),
                  **_universe_kwargs(edm))
    if fold:
        fold_weight_norm(pm)
    assert from_jax_params(pm, params) == []

    calls = []
    real = conv_block.fused_conv_chain_reference
    monkeypatch.setattr(conv_block, "fused_conv_chain_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = pm.enhance(mix, n_steps=N_STEPS, noise=_jax_noise(key, N_STEPS - 1))
    assert len(calls) == (CHAIN_CALLS if fold else 0)
    assert out.shape == (B, T) and torch.isfinite(out).all()
    record_property("max_abs_diff", float(np.abs(out.numpy() - ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)


def _jax_draws(key, shape, n_steps, warm_start=None, probe=False):
    """JAX's draws in the order the port's ``noise`` takes them
    (models/universe.py:565-577,608,530-538): the initial one from k_init,
    step i from step_keys[n_loop + i], then the probe's, step_keys[i] and
    step_keys[2 n_loop] for the final score."""
    n_loop = n_steps - 1 - (warm_start or 0)
    k_init, k_loop = jax.random.split(key)
    step_keys = jax.random.split(k_loop, 2 * n_loop + 1)
    keys = [k_init] + [step_keys[n_loop + i] for i in range(n_loop)]
    if probe:
        keys += [step_keys[i] for i in range(n_loop)] + [step_keys[2 * n_loop]]
    return [np.array(jax.random.normal(k, shape)) for k in keys]


# enhance arguments beyond the sampler's: (kwargs, steps); E members of the
# batch are E * B rows of noise
_REST_CASES = {
    "median_even_2": (dict(ensemble=2, ensemble_stat="median"), 3),
    "median_even_4": (dict(ensemble=4, ensemble_stat="median"), 3),
    "mean_keep_rms": (dict(ensemble=3, ensemble_stat="mean", keep_rms=True), 3),
    "signal_median": (dict(ensemble=3, ensemble_stat="signal_median"), 3),
    "warm_start": (dict(warm_start=2), 4),
    "use_aux_signal": (dict(use_aux_signal=True), 3),
    "target_probe": (dict(fake_score_snr=10.0, ensemble=2, ensemble_stat="mean"), 3),
}


@pytest.fixture(scope="module")
def gan_pair():
    """The small networks as UNIVERSE++ with the snake signal-decoupling
    layer, folded, in both packages with the same weights."""
    jm = JaxUniverseGAN(
        score_model=JaxScore(**_SCORE), condition_model=JaxCond(**_COND),
        losses={"weights": {"score": 1.0}, "use_signal_decoupling": True,
                "signal_decoupling_act": "snake"}, **_universe_kwargs(True))
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda p: jax_fold(jm, p))(_jax_params(jm, seed=3)))
    pm = UniverseGAN(score_model=ScoreNetwork(**_SCORE),
                     condition_model=ConditionerNetwork(**_COND),
                     use_signal_decoupling=True, signal_decoupling_act="snake",
                     **_universe_kwargs(True))
    fold_weight_norm(pm)
    assert from_jax_params(pm, params) == []
    return jm, params, pm


@pytest.mark.parametrize("case", list(_REST_CASES))
def test_enhance_arguments_match_jax(gan_pair, record_property, case):
    jm, params, pm = gan_pair
    kwargs, n_steps = _REST_CASES[case]
    rng = np.random.default_rng(2)
    mix = rng.standard_normal((B, T)).astype(np.float32) * 0.1
    if case == "target_probe":
        kwargs = dict(kwargs, target=mix * 0.5 + 0.01 * rng.standard_normal(
            (B, T)).astype(np.float32))
    key = jax.random.key(4)
    static = {k: v for k, v in kwargs.items() if k != "target"}
    ref = np.asarray(jax.jit(lambda p, m, tgt: jm.enhance(
        p, m, key=key, n_steps=n_steps, packed=False, target=tgt, **static))(
        params, jnp.asarray(mix), kwargs.get("target")))
    rows = B * kwargs.get("ensemble", 1)
    noise = ([] if kwargs.get("use_aux_signal") else
             _jax_draws(key, (rows, T_PADDED, 1), n_steps,
                        kwargs.get("warm_start"), "target" in kwargs))
    out = pm.enhance(mix, n_steps=n_steps, noise=noise, **kwargs)
    assert out.shape == (B, T) and torch.isfinite(out).all()
    record_property("max_abs_diff", float(np.abs(out.numpy() - ref).max()))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=0)


def test_even_median_averages_the_middle_members():
    """torch.median returns the lower middle member; jnp.median, and so
    the port, the mean of the two."""
    from open_universe_tpu_torch.models.universe import ensemble_reduce

    x = torch.tensor([1.0, 10.0, 2.0, 3.0]).reshape(4, 1, 1, 1)
    assert float(ensemble_reduce(x, "median")) == 2.5
    assert np.asarray(jnp.median(jnp.asarray(x.numpy()), axis=0)).item() == 2.5
    assert torch.median(x, dim=0).values.item() == 2.0
    with pytest.raises(NotImplementedError):
        ensemble_reduce(x, "mode")


def test_main_path_imports_no_jax():
    """The port's main path, its serving path and its CLI, run end to end
    on the CPU (enhance; a checkpoint loaded by ``load_model`` and served
    over HTTP; the CLI on a stereo FLAC in chunks, with the codecs and the
    native FLAC loader imported), load neither jax nor any module of the JAX
    package."""
    code = textwrap.dedent(f"""
        import io, sys, tempfile, threading, urllib.request
        from pathlib import Path
        import numpy as np
        import torch
        import yaml
        from scipy.io import wavfile
        from open_universe_tpu_torch.bin.serve import make_server
        from open_universe_tpu_torch.inference.model_loader import load_model
        from open_universe_tpu_torch.models.condition import ConditionerNetwork
        from open_universe_tpu_torch.models.presets import universepp
        from open_universe_tpu_torch.models.score import ScoreNetwork
        from open_universe_tpu_torch.models.universe_gan import UniverseGAN
        from open_universe_tpu_torch.nn.layers import init_weights
        from open_universe_tpu_torch.utils.convert import fold_weight_norm

        model = UniverseGAN(score_model=ScoreNetwork(**{_SCORE!r}),
                            condition_model=ConditionerNetwork(**{_COND!r}),
                            edm={{"noise": 0.25}})
        init_weights(model, seed=0)
        tmp = Path(tempfile.mkdtemp())
        torch.save({{"state_dict": model.state_dict()}}, tmp / "weights.ckpt")
        target = "open_universe.networks.universe."
        cfg = {{"_target_": target + "UniverseGAN", "edm": {{"noise": 0.25}},
                "score_model": {{"_target_": target + "ScoreNetwork", **{_SCORE!r}}},
                "condition_model": {{"_target_": target + "ConditionerNetwork",
                                     **{_COND!r}}}}}
        (tmp / "config.yaml").write_text(yaml.safe_dump({{"model": cfg}}))

        fold_weight_norm(model)
        mix = torch.randn(2, 640, generator=torch.Generator().manual_seed(0))
        out = model.enhance(mix * 0.1, n_steps=3,
                            generator=torch.Generator().manual_seed(1))
        assert out.shape == (2, 640) and bool(torch.isfinite(out).all())

        served = load_model(tmp / "weights.ckpt", load_ema=False, device="cpu")
        srv, service = make_server(served, port=0, batch_window_ms=1.0,
                                   enhance_kwargs={{"n_steps": 2}})
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        buf = io.BytesIO()
        wavfile.write(buf, 16000, (np.sin(np.arange(800) / 5) * 3000).astype(np.int16))
        url = f"http://127.0.0.1:{{srv.server_address[1]}}/enhance"
        with urllib.request.urlopen(urllib.request.Request(url, data=buf.getvalue()),
                                    timeout=60) as r:
            assert r.status == 200 and len(r.read()) == 44 + 2 * 800
        srv.shutdown()
        service.close()

        import open_universe_tpu_torch.data.codecs
        import open_universe_tpu_torch.inference.chunked
        import open_universe_tpu_torch.native
        from open_universe_tpu_torch.bin.enhance import main as enhance_main
        from open_universe_tpu_torch.data.audio import load_audio, save_audio

        (tmp / "in").mkdir()
        save_audio(tmp / "in" / "a.flac", np.sin(np.arange(1600).reshape(2, 800) / 5) * 0.1,
                   16000)
        assert enhance_main([str(tmp / "in"), str(tmp / "out"), "--model",
                             str(tmp / "weights.ckpt"), "--device", "cpu",
                             "--n_steps", "2", "--chunk-seconds", "0.05"]) == 0
        assert load_audio(tmp / "out" / "a.flac")[0].shape == (2, 800)
        if not torch.cuda.is_available():
            try:  # entry points run on CUDA unless asked for the CPU
                universepp()
            except RuntimeError:
                pass
            else:
                raise AssertionError("universepp() ran without a GPU")
        loaded = [m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "open_universe_tpu."))
                  or m == "open_universe_tpu"]
        assert not loaded, loaded
        print("ok")
    """)
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")
