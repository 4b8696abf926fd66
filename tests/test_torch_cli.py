"""The PyTorch port's enhance CLI (``bin/enhance.py``) and chunked
overlap-add (``inference/chunked.py``) against the JAX package's, on the
CPU.

Both CLIs enhance one input tree (mono and stereo; 16 kHz and other rates;
WAV, FLAC and, where libmpg123 and libmp3lame load, MP3) from one
reference-layout checkpoint of ``TINY_GAN_CFG`` (UNIVERSE++ with the snake
signal-decoupling layer, an EMA shadow that differs from the raw weights)
with ``--use_aux_signal true``, which involves no noise: bucketed, and with
``--chunk-seconds``.  WAV and FLAC outputs agree within 2e-5 + 1/32767 (the
sampler bound plus one step of the 16-bit output); MP3 is lossy and held for
rate, length and channels.  The JAX CLI runs once per mode, in a
module-scoped fixture.  The loaded signal-decoupling layer's ``aux_to_wav``
holds JAX's within 1e-5, the crossfade window is equal bit for bit, and the
overlap-add blend (through a stand-in model whose enhance is a gain) within
1e-6.
"""
import numpy as np
import pytest
from threadpoolctl import threadpool_limits
import yaml

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from open_universe_tpu.bin.enhance import main as jax_main  # noqa: E402
from open_universe_tpu.configs.registry import instantiate as jax_instantiate  # noqa: E402
from open_universe_tpu.inference import chunked as jax_chunked  # noqa: E402
from open_universe_tpu.inference.model_loader import load_model as jax_load_model  # noqa: E402
from open_universe_tpu.inference.torch_convert import (  # noqa: E402
    ordered_param_names,
    to_torch_state_dict,
)
from open_universe_tpu_torch.bin import enhance as port_enhance  # noqa: E402
from open_universe_tpu_torch.configs.registry import instantiate  # noqa: E402
from open_universe_tpu_torch.data.audio import load_audio, save_audio  # noqa: E402
from open_universe_tpu_torch.inference import chunked, model_loader  # noqa: E402

from test_checkpoint_conversion import TINY_GAN_CFG  # noqa: E402
from test_torch_codecs import mp3_libraries  # noqa: E402

FS = 16000
TOL = 2e-5 + 1.0 / 32767
EMA_SUBS = ["_edm_model", "condition_model", "signal_decoupling_layer"]
CLI_ARGS = ["--batch-size", "2", "--bucket-seconds", "0.5", "--use_aux_signal", "true"]
CHUNK_ARGS = ["--chunk-seconds", "0.2"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    more oversubscribe the cores the other test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):  # numpy's BLAS too
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A reference-layout checkpoint of TINY_GAN_CFG with numpy-drawn
    weights; the EMA shadow halves every weight but the signal-decoupling
    layer's, which the reference never optimises."""
    tmp = tmp_path_factory.mktemp("ckpt")
    jm = jax_instantiate(TINY_GAN_CFG)
    rng = np.random.default_rng(0)
    params = {name: jax.tree_util.tree_map(
        lambda s: (rng.uniform(-1, 1, s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                   if len(s.shape) > 1 else rng.uniform(-0.5, 0.5, s.shape))
        .astype(np.float32), jax.eval_shape(getattr(jm, name).init, jax.random.key(0)))
        for name in jm.model_param_keys()}
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          to_torch_state_dict(jm, params, edm=True).items()}
    names = ordered_param_names(sd, EMA_SUBS)
    shadow = [sd[n] if n.startswith("signal_decoupling_layer.") else sd[n] * 0.5
              for n in names]
    torch.save({"state_dict": sd, "ema": {"shadow_params": shadow, "decay": 0.999}},
               tmp / "weights.ckpt")
    (tmp / "config.yaml").write_text(yaml.safe_dump({"model": TINY_GAN_CFG}))
    return tmp / "weights.ckpt"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Input files: (relative path, rate, channels, seconds)."""
    root = tmp_path_factory.mktemp("in")
    files = [("a.wav", 16000, 1, 0.3), ("b.flac", 16000, 2, 0.3),
             ("sub/c.wav", 22050, 1, 0.4), ("sub/d.flac", 8000, 1, 0.45)]
    if mp3_libraries():
        files.append(("e.mp3", 16000, 1, 0.3))
    rng = np.random.default_rng(5)
    for name, fs, ch, seconds in files:
        t = int(fs * seconds)
        x = (0.1 * np.sin(2 * np.pi * 300 * np.arange(t) / fs)
             + 0.03 * rng.standard_normal((ch, t))).astype(np.float32)
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        save_audio(root / name, x[0] if ch == 1 else x, fs)
    return root, files


@pytest.fixture(scope="module")
def jax_outputs(ckpt, tree, tmp_path_factory):
    """The JAX CLI's output trees, bucketed and chunked."""
    root, _ = tree
    out = {}
    for mode, extra in (("bucketed", []), ("chunked", CHUNK_ARGS)):
        out[mode] = tmp_path_factory.mktemp(f"jax_{mode}")
        assert jax_main([str(root), str(out[mode]), "--model", str(ckpt),
                         *CLI_ARGS, *extra]) == 0
    return out


@pytest.mark.parametrize("mode", ["bucketed", "chunked"])
def test_cli_matches_jax_cli(ckpt, tree, jax_outputs, tmp_path, record_property, mode):
    root, files = tree
    extra = CHUNK_ARGS if mode == "chunked" else []
    assert port_enhance.main([str(root), str(tmp_path), "--model", str(ckpt),
                              "--device", "cpu", *CLI_ARGS, *extra]) == 0
    worst = 0.0
    for name, fs, ch, seconds in files:
        got, got_fs = load_audio(tmp_path / name)
        want, want_fs = load_audio(jax_outputs[mode] / name)
        assert got_fs == want_fs == fs and got.shape == want.shape
        assert got.shape[0] == ch and np.isfinite(got).all() and np.abs(got).max() > 1e-2
        if name.endswith(".mp3"):  # lossy: held for rate, length, channels
            continue
        assert got.shape[1] == int(fs * seconds)
        worst = max(worst, float(np.abs(got - want).max()))
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=name)
    assert sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*.*")) \
        == sorted(name for name, *_ in files)
    record_property("max_abs_diff", worst)


def test_load_model_keeps_the_signal_decoupling_layer(ckpt, rng):
    """The layer's weights and EMA shadows load (none of its keys skipped),
    and ``aux_to_wav`` equals JAX's on the loaded weights within 1e-5."""
    data = torch.load(ckpt, weights_only=False)
    skipped = model_loader.load_state(instantiate(TINY_GAN_CFG), data["state_dict"],
                                      data["ema"]["shadow_params"])
    assert not [k for k in skipped if k.startswith("signal_decoupling_layer.")]
    model = model_loader.load_model(ckpt, device="cpu")
    assert model.signal_decoupling_layer.act_type == "snake"
    jm, jparams = jax_load_model(str(ckpt), fold_wn=False)
    y = (rng.standard_normal((2, 160, 4)) * 0.5).astype(np.float32)
    with torch.no_grad():
        got = model.aux_to_wav(torch.from_numpy(y)).numpy()
    want = np.asarray(jm.aux_to_wav(jparams, jnp.asarray(y)))
    assert got.shape == (2, 160, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_cli_runs_on_cuda_unless_asked_for_the_cpu(ckpt, tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the rule is held where there is none")
    root, _ = tree
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_enhance.main([str(root), str(tmp_path), "--model", str(ckpt)])


@pytest.mark.parametrize("chunk,ov", [(3200, 800), (100, 60), (64, 0), (7, 7)])
def test_crossfade_window_matches_jax(chunk, ov):
    np.testing.assert_array_equal(chunked._crossfade_window(chunk, ov),
                                  jax_chunked._crossfade_window(chunk, ov))


class _Gain:
    """A stand-in model whose enhance is a gain and an offset: the blend
    alone."""

    fs = 1000

    def __init__(self):
        self.seen = []

    def enhance(self, *args, keep_rms=False, **kwargs):
        mix = args[-1]
        self.seen.append((tuple(mix.shape), keep_rms))
        return mix * 1.5 + 0.01


@pytest.mark.parametrize("t,overlap", [(950, 0.25), (200, 0.25), (1234, 0.6), (300, 0.0)])
def test_overlap_add_blend_matches_jax(rng, t, overlap):
    """Chunking, the max_batch blocks and the weight-normalised overlap-add,
    through a model whose enhance is a gain, for one row and for three."""
    x = rng.standard_normal((3, t)).astype(np.float32)
    port_model, jax_model = _Gain(), _Gain()
    port_fn = chunked.make_chunked_enhancer(port_model, chunk_seconds=0.2,
                                            overlap=overlap, max_batch=2)
    jax_fn = jax_chunked.make_chunked_enhancer(jax_model, chunk_seconds=0.2,
                                               overlap=overlap, max_batch=2)
    for mix in (x, x[0]):
        got = port_fn(mix)
        want = np.asarray(jax_fn(None, mix, key=jax.random.key(0)))
        assert got.shape == mix.shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # blocks of at most 2 rows, keep_rms on by default; JAX pads the last
    # block to 2 rows, the port does not
    assert {s for s, _ in port_model.seen} <= {(2, 200), (1, 200)}
    assert all(keep for _, keep in port_model.seen)
    np.testing.assert_allclose(
        chunked.enhance_chunked(port_model, x, chunk_seconds=0.2, overlap=overlap,
                                max_batch=2), port_fn(x), atol=0, rtol=0)


def test_chunked_refuses_what_jax_refuses():
    model = _Gain()
    for kwargs in (dict(overlap=1.0), dict(overlap=-0.1),
                   dict(chunk_seconds=0.001, overlap=0.9)):
        with pytest.raises(ValueError):
            chunked.make_chunked_enhancer(model, **kwargs)
        with pytest.raises(ValueError):
            jax_chunked.make_chunked_enhancer(_Gain(), **kwargs)


def test_out_suffix_and_find_files(tmp_path):
    from pathlib import Path

    assert port_enhance._out_suffix(Path("a/b.FLAC")) == Path("a/b.FLAC")
    assert port_enhance._out_suffix(Path("a/b.ogg")) == Path("a/b.wav")
    (tmp_path / "x").mkdir()
    for name in ("x/1.wav", "2.flac", "3.txt", "4.mp3"):
        (tmp_path / name).write_bytes(b"")
    files, rel, is_tree = port_enhance.find_files(tmp_path)
    assert [p.relative_to(tmp_path).as_posix() for p in files] == [
        "2.flac", "4.mp3", "x/1.wav"] and rel == tmp_path and is_tree
    assert port_enhance.find_files(tmp_path / "2.flac") == (
        [tmp_path / "2.flac"], tmp_path, False)
