"""The port's phoneme losses, its wav2vec2 CTC model and the LPS metric
against the JAX package, at float32 on the CPU.

The model is the tiny random wav2vec2 of ``tests/test_gated_paths.py``
(hidden 32, 2 layers, 3 conv layers, 40 phonemes): Flax's
``FlaxWav2Vec2ForCTC`` on the JAX side (injected as ``model=`` behind a
wrapper that jits its forward), the port's ``nn/wav2vec2.py`` on the other,
with the weights carried over by ``utils/convert.py::from_flax_wav2vec2``.
The loader is held against ``transformers``' torch ``Wav2Vec2ForCTC``
checkpoints, the LPS decoder against ``Wav2Vec2PhonemeCTCTokenizer``, and
LPS's default predictor against the JAX package's on one checkpoint
directory.  Nothing is downloaded.
"""
import copy
import json
import types
from pathlib import Path

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from open_universe_tpu.losses import phoneme_loss as jphoneme  # noqa: E402
from open_universe_tpu.metrics import lps as jlps  # noqa: E402
from open_universe_tpu.models.enhancement import EnhancementBaseModel as JEnh  # noqa: E402
from open_universe_tpu.nn.layers import Conv1d as JConv1d  # noqa: E402
from open_universe_tpu_torch.losses import phoneme_loss as pphoneme  # noqa: E402
from open_universe_tpu_torch.metrics import lps as plps  # noqa: E402
from open_universe_tpu_torch.models.enhancement import EnhancementBaseModel  # noqa: E402
from open_universe_tpu_torch.nn import wav2vec2 as pw2v  # noqa: E402
from open_universe_tpu_torch.nn.layers import Conv1d  # noqa: E402
from open_universe_tpu_torch.utils.convert import from_flax_wav2vec2, from_jax_params  # noqa: E402

FS = 16000
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
            conv_dim=(16, 16, 16), conv_stride=(5, 2, 2), conv_kernel=(10, 3, 3),
            num_feat_extract_layers=3, vocab_size=40, do_stable_layer_norm=True,
            feat_extract_norm="layer", pad_token_id=0)
VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "a": 4, "b": 5, "ɪ": 6, "k": 7}
CTC_TARGET = "open_universe_tpu.losses.PhonemeCTCLoss"
CONFIG_DIR = Path(__file__).resolve().parents[1] / "config"
LOSS_TARGET = "open_universe_tpu.losses.MultiResL1SpecLoss"


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


class _JaxModel:
    """The Flax model as JAX's ``PhonemePredictor`` calls it: ``.config``
    and ``__call__(x).logits``, the forward jitted once per shape;
    ``upcast`` hands the logits on as float64 (under ``jax.enable_x64``)."""

    def __init__(self, flax_model, params, upcast=False):
        self.config = flax_model.config
        self.params = params
        self.upcast = upcast
        self._logits = jax.jit(lambda p, x: flax_model(x, params=p).logits)

    def __call__(self, x):
        logits = self._logits(self.params, x)
        return types.SimpleNamespace(logits=logits.astype(jnp.float64) if self.upcast
                                     else logits)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):  # numpy's BLAS too
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def transformers():
    """Imported by the tests that use it, not while every worker collects."""
    return pytest.importorskip("transformers")


def _draw_params(shapes, seed=0):
    """Numpy weights in the Flax tree's shapes (JAX's eager init of the
    model takes ~8 s): conv kernels He-normal, Dense kernels and biases
    N(0, 0.02^2), LayerNorm scales 1 + N(0, 0.02^2), the positional conv's
    ``weight_g`` the norm of its ``weight_v`` per tap, scaled by 1 +
    U(-0.1, 0.1)."""
    from flax.traverse_util import flatten_dict, unflatten_dict

    rng = np.random.default_rng(seed)
    flat = flatten_dict(shapes)
    out = {}
    for path in sorted(flat):
        shape, name = flat[path].shape, path[-1]
        if name in ("kernel", "weight_v") and len(shape) == 3:
            fan_in = shape[1] * (shape[0] if name == "kernel" else shape[2])
            v = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
        elif name == "scale":
            v = 1.0 + 0.02 * rng.standard_normal(shape)
        elif name == "weight_g":
            continue
        else:
            v = 0.02 * rng.standard_normal(shape)
        out[path] = v.astype(np.float32)
    for path in flat:
        if path[-1] == "weight_g":
            v = out[path[:-1] + ("weight_v",)]
            norm = np.linalg.norm(v, axis=(0, 1), keepdims=True)
            out[path] = (norm * rng.uniform(0.9, 1.1, norm.shape)).astype(np.float32)
    return unflatten_dict(out)


@pytest.fixture(scope="module")
def tiny(transformers):
    """(JAX-side model, port model, the transformers config, the Flax
    model, its weights): the same weights on both sides."""
    cfg = transformers.Wav2Vec2Config(**TINY)
    flax_model = transformers.FlaxWav2Vec2ForCTC(cfg, input_shape=(1, 1024), _do_init=False)
    params = _draw_params(jax.eval_shape(
        lambda: flax_model.init_weights(jax.random.key(0), (1, 1024))))
    port = pw2v.Wav2Vec2ForCTC(pw2v.Wav2Vec2Config.from_dict(cfg.to_dict()))
    port.load_state_dict(from_flax_wav2vec2(params))
    return (_JaxModel(flax_model, params), port.eval().requires_grad_(False), cfg, flax_model,
            params)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory, tiny, transformers):
    """A seeded ``transformers`` torch Wav2Vec2ForCTC of the tiny config,
    written by its ``save_pretrained`` as ``.bin`` and as ``.safetensors``,
    each with a ``Wav2Vec2Processor`` (phoneme tokenizer, feature
    extractor) beside it."""
    torch.manual_seed(0)
    model = transformers.Wav2Vec2ForCTC(tiny[2]).eval()
    root = tmp_path_factory.mktemp("w2v")
    (root / "vocab.json").write_text(json.dumps(VOCAB), encoding="utf-8")
    tok = transformers.Wav2Vec2PhonemeCTCTokenizer(str(root / "vocab.json"),
                                                   do_phonemize=False)
    fe = transformers.Wav2Vec2FeatureExtractor(feature_size=1, sampling_rate=FS,
                                               padding_value=0.0, do_normalize=True,
                                               return_attention_mask=False)
    dirs = {}
    for kind, safe in (("bin", False), ("safetensors", True)):
        d = root / kind
        model.save_pretrained(d, safe_serialization=safe)
        transformers.Wav2Vec2Processor(feature_extractor=fe, tokenizer=tok).save_pretrained(d)
        dirs[kind] = d
    return model, dirs


def _wav(n, seed=5, batch=2):
    """test_gated_paths' tone (a 220 Hz carrier under a 3 Hz envelope, a
    little noise), one row per seed offset."""
    rows = []
    for i in range(batch):
        rng = np.random.default_rng(seed + i)
        t = np.arange(n) / FS
        x = 0.3 * np.sin(2 * np.pi * (220 + 40 * i) * t) * np.sin(2 * np.pi * 3 * t) ** 2
        rows.append(x + 0.01 * rng.standard_normal(n))
    return np.stack(rows).astype(np.float32)


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("n", [8000, 7777])
def test_predictor_logits_match_jax(tiny, n, record_property):
    """The predictor (per-row normalisation, then the model) on (B, T) and
    (B, T, 1): <= 1e-5 max(1, max|JAX|)."""
    jmodel, port, *_ = tiny
    x = _wav(n)
    want = np.asarray(jphoneme.PhonemePredictor(model=jmodel)(jnp.asarray(x)))
    pred = pphoneme.PhonemePredictor(model=port)
    got = pred(torch.from_numpy(x)).numpy()
    got3 = pred(torch.from_numpy(x[:, :, None])).numpy()
    assert got.shape == want.shape == (2, want.shape[1], 40)
    err = np.abs(got - want).max()
    record_property("max_abs_diff", float(err))
    assert err <= 1e-5 * max(1.0, np.abs(want).max())
    np.testing.assert_array_equal(got3, got)


# ------------------------------------------------------------ the losses
@pytest.mark.parametrize("name,sr", [("PhonemeEmbeddingLoss", 16000), ("PhonemeLoss", 16000),
                                     ("PhonemeCTCLoss", 16000), ("PhonemeCTCLoss", 24000)])
def test_loss_and_gradient_match_jax(tiny, name, sr, record_property):
    """Each loss on an estimate near its target, and its gradient with
    respect to the estimate (through the frozen model; the target's logits
    carry none): loss <= 1e-5 relative, gradient <= 1e-4 max|g_JAX|.  The
    CTC loss's labels (collapsed, de-blanked argmax of the target) equal
    JAX's.  At 24 kHz both resample to 16 kHz first.

    The CTC gradient is held against JAX's with its CTC recursion in
    float64, as the port runs it (the model float32 on both sides): here
    optax's float32 gradient is ~4e-4 of its largest off the port's
    (recorded at 16 kHz as ``grad_rel_jax_f32``), the port's ~6e-7 off a
    float64 reference."""
    jmodel, port, _, flax_model, params = tiny
    tgt = _wav(sr // 2)
    est = (tgt + 0.05 * np.random.default_rng(9).standard_normal(tgt.shape)).astype(np.float32)
    jl = getattr(jphoneme, name)(model=jmodel, sr=sr)
    pl = getattr(pphoneme, name)(model=port, sr=sr)
    e = torch.from_numpy(est.copy()).requires_grad_(True)
    val_p = pl(e, torch.from_numpy(tgt))
    val_p.backward()
    g_p = e.grad.numpy()
    if name == "PhonemeCTCLoss" and sr != FS:  # JAX's float32 gradient is not compared
        val_j = jl(jnp.asarray(est), jnp.asarray(tgt))
    else:
        val_j, g_j = jax.value_and_grad(lambda e: jl(e, jnp.asarray(tgt)))(jnp.asarray(est))
        g_j = np.asarray(g_j)
    if name == "PhonemeCTCLoss":
        if sr == FS:
            record_property("grad_rel_jax_f32",
                            float(np.abs(g_p - g_j).max() / np.abs(g_j).max()))
        with jax.enable_x64(True):
            jl64 = jphoneme.PhonemeCTCLoss(model=_JaxModel(flax_model, params, upcast=True),
                                           sr=sr)
            g_j = np.asarray(jax.grad(lambda e: jl64(e, jnp.asarray(tgt)))(jnp.asarray(est)))
    loss_rel = _rel(float(val_p.detach()), float(val_j))
    grad_rel = float(np.abs(g_p - g_j).max() / np.abs(g_j).max())
    record_property("loss_rel", loss_rel)
    record_property("grad_rel", grad_rel)
    assert np.isfinite(float(val_j)) and loss_rel <= 1e-5
    assert grad_rel <= 1e-4
    assert not any(p.requires_grad or p.grad is not None for p in port.parameters())
    if name == "PhonemeCTCLoss":
        lab_j, len_j = jl._targets_to_ctc(jnp.asarray(tgt))
        lab_p, len_p = pl._targets_to_ctc(torch.from_numpy(tgt))
        np.testing.assert_array_equal(lab_p.numpy(), np.asarray(lab_j))
        np.testing.assert_array_equal(len_p.numpy(), np.asarray(len_j))
        assert len_p.min() > 0


def test_ctc_helper_matches_optax(record_property):
    """``ctc_loss`` against JAX's formula (``optax.ctc_loss`` on unpadded
    logits, over max(label length, 1), the mean) on given logits, one row
    with an empty label, and each row alone: <= 1e-5 relative."""
    rng = np.random.default_rng(2)
    b, t, v, blank = 3, 60, 12, 0
    logits = (3.0 * rng.standard_normal((b, t, v))).astype(np.float32)
    labels = np.zeros((b, 9), np.int32)
    lengths = np.asarray([9, 0, 4], np.int32)
    for i, n in enumerate(lengths):
        labels[i, :n] = rng.integers(1, v, n)

    def want(rows):
        pad = (np.arange(9)[None] >= lengths[rows, None]).astype(np.float32)
        loss = optax.ctc_loss(jnp.asarray(logits[rows]), jnp.zeros((len(rows), t)),
                              jnp.asarray(labels[rows]), jnp.asarray(pad), blank_id=blank)
        return float(jnp.mean(loss / jnp.maximum(jnp.asarray(lengths[rows]), 1)))

    worst = 0.0
    for rows in ([0, 1, 2], [0], [1], [2]):
        got = float(pphoneme.ctc_loss(torch.from_numpy(logits[rows]),
                                      torch.from_numpy(labels[rows]),
                                      torch.from_numpy(lengths[rows]), blank))
        worst = max(worst, _rel(got, want(rows)))
    record_property("loss_rel", worst)
    assert worst <= 1e-5


def test_compute_losses_matches_jax(tiny, record_property):
    """``EnhancementBaseModel.compute_losses`` (the 5-tap model of
    test_torch_losses) with a multi-resolution L1 and the CTC phoneme loss,
    as ``universe_lora.yaml`` weighs them: the total and each part <= 1e-5
    relative, the total's gradient with respect to the estimate <= 1e-4
    max|g_JAX|; JAX's CTC recursion in float64, as in
    ``test_loss_and_gradient_match_jax``."""
    _, port, _, flax_model, w2v_params = tiny

    def losses(model):
        return {"multires_l1": {"weight": 0.1, "kwargs": {"_target_": LOSS_TARGET,
                                                          "window_sz": [64, 256],
                                                          "time_domain_weight": 0.0}},
                "phonemeloss": {"weight": 0.01, "kwargs": {"_target_": CTC_TARGET, "sr": FS,
                                                           "model": model}}}

    rng = np.random.default_rng(3)
    params = {"model": {"weight": (rng.uniform(-1, 1, (5, 1, 1)) * 0.6).astype(np.float32),
                        "bias": np.asarray([0.01], np.float32)}}
    kw = dict(fs=FS, normalization_kwargs={"ref": "both", "level_db": -26.0})
    jm = JEnh(model=JConv1d(1, 1, 5),
              losses=losses(_JaxModel(flax_model, w2v_params, upcast=True)), **kw)
    pm = EnhancementBaseModel(model=Conv1d(1, 1, 5), losses=losses(port), **kw)
    assert from_jax_params(pm, params) == []
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tgt = _wav(8000)[:, :, None]
    est = (tgt + 0.05 * rng.standard_normal(tgt.shape)).astype(np.float32)
    with jax.enable_x64(True):
        (tot_j, parts_j), g_j = jax.value_and_grad(
            lambda e: jm.compute_losses(jp, e, jnp.asarray(tgt)), has_aux=True)(jnp.asarray(est))
    e = torch.from_numpy(est.copy()).requires_grad_(True)
    tot_p, parts_p = pm.compute_losses(e, torch.from_numpy(tgt))
    tot_p.backward()
    assert set(parts_p) == set(parts_j) == {"multires_l1", "phonemeloss"}
    for k in parts_j:
        assert _rel(float(parts_p[k].detach()), float(parts_j[k])) <= 1e-5, k
    assert _rel(float(tot_p.detach()), float(tot_j)) <= 1e-5
    g_j = np.asarray(g_j)
    grad_rel = float(np.abs(e.grad.numpy() - g_j).max() / np.abs(g_j).max())
    record_property("grad_rel", grad_rel)
    assert grad_rel <= 1e-4
    assert not any(k.startswith("losses") or "wav2vec2" in k for k in pm.state_dict())


# ------------------------------------------------------------ loading
@pytest.mark.parametrize("kind", ["bin", "safetensors"])
def test_load_pretrained_reads_transformers_checkpoints(hf_dirs, kind, record_property):
    """``load_pretrained`` reads what ``transformers``' ``save_pretrained``
    wrote (``pytorch_model.bin``, or ``model.safetensors`` through the
    in-house reader; the weight norm's parametrisation names; strict): its
    logits equal that model's within 1e-5."""
    model, dirs = hf_dirs
    files = {p.name for p in dirs[kind].iterdir()}
    assert ("model.safetensors" in files) == (kind == "safetensors")
    port = pw2v.load_pretrained(dirs[kind])
    assert not port.training and not any(p.requires_grad for p in port.parameters())
    x = torch.from_numpy(_wav(6000))
    with torch.no_grad():
        want = model(x).logits
        got = port(x)
    err = (got - want).abs().max().item()
    record_property("max_abs_diff", err)
    assert got.shape == want.shape and err <= 1e-5


def test_checkpoint_resolution_and_refusal(hf_dirs, tmp_path, monkeypatch):
    """A hub id resolves only to a snapshot of the local Hugging Face cache
    (``refs/main``'s, under ``$HF_HUB_CACHE``); without one the predictor
    raises ``FileNotFoundError`` naming the files it needs."""
    _, dirs = hf_dirs
    for var, val in (("HF_HUB_CACHE", tmp_path / "none"), ("HF_HOME", tmp_path / "home"),
                     ("HOME", tmp_path)):
        monkeypatch.setenv(var, str(val))
    with pytest.raises(FileNotFoundError, match="config.json"):
        pphoneme.PhonemeCTCLoss()
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        plps.LevenshteinPhonemeSimilarity(device="cpu")
    repo = tmp_path / "hub" / "models--facebook--wav2vec2-lv-60-espeak-cv-ft"
    (repo / "snapshots").mkdir(parents=True)
    (repo / "snapshots" / "0123abc").symlink_to(dirs["bin"])
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("0123abc")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert pw2v.resolve_checkpoint() == repo / "snapshots" / "0123abc"
    loss = pphoneme.PhonemeCTCLoss()
    assert loss.blank == 0 and loss.phoneme_predictor.model.config.vocab_size == 40


# ------------------------------------------------------------ LPS
def test_levenshtein_and_lps_with_a_mock_predictor_match_jax():
    """``levenshtein_distance`` on the JAX tests' cases; LPS with JAX's
    mock predictor (test_gated_paths) at 16 and 24 kHz equals JAX's; an
    empty reference string raises ZeroDivisionError on both sides."""
    for a, b in (("kitten", "sitting"), ("", "abc"), ("abc", "abc"), ("flaw", "lawn")):
        assert plps.levenshtein_distance(a, b) == jlps.levenshtein_distance(a, b)
        assert plps._distance(a, b) == jlps._distance(a, b)

    class MockPredictor:
        sr = FS

        def __call__(self, audio):
            e = float(np.mean(np.square(np.asarray(audio))))
            return "a b a k" if e > 1e-4 else "a b"

    wav = _wav(FS // 2)[0]
    for sr in (FS, 24000):
        pl = plps.LevenshteinPhonemeSimilarity(sr=sr, predictor=MockPredictor())
        jl = jlps.LevenshteinPhonemeSimilarity(sr=sr, predictor=MockPredictor())
        for s in (wav, wav * 1e-4):
            assert pl(s, wav) == jl(s, wav)
    assert pl(wav * 1e-4, wav) == pytest.approx(0.5)
    for lps in (pl, jl):
        lps.phoneme_predictor = lambda audio: ""
        with pytest.raises(ZeroDivisionError):
            lps(wav, wav)


def test_decoder_matches_the_phoneme_tokenizer(tmp_path, transformers):
    """``PhonemeDecoder`` against ``Wav2Vec2PhonemeCTCTokenizer(
    do_phonemize=False).batch_decode``: repeats collapsed, the pad dropped,
    special tokens kept, unknown ids as ``<unk>``, joined with spaces."""
    (tmp_path / "vocab.json").write_text(json.dumps(VOCAB), encoding="utf-8")
    tok = transformers.Wav2Vec2PhonemeCTCTokenizer(str(tmp_path / "vocab.json"),
                                                   do_phonemize=False)
    dec = plps.PhonemeDecoder.from_dir(tmp_path, pad_id=0)
    cases = [[0, 4, 4, 0, 5, 5, 6, 0, 1, 7, 3], [0, 0], [9, 10, 4], [3, 3, 9], [4, 0, 4, 2]]
    assert [dec(c) for c in cases] == tok.batch_decode(cases)
    assert dec(cases[0]) == "a b ɪ <s> k <unk>"


def test_lps_default_predictor_matches_jax(hf_dirs, tmp_path, monkeypatch):
    """LPS's default predictor (the port's model, normalisation, argmax and
    decoder, on the CPU) against the JAX package's (``transformers``'
    processor and torch model) on one checkpoint directory: the same
    phoneme strings and the same LPS; ``Metrics(["lps"])`` and
    ``EvalMetrics(lps=True)`` build it from the default id in the local
    cache and report it."""
    from open_universe_tpu_torch import metrics as pmetrics

    _, dirs = hf_dirs
    pl = plps.LevenshteinPhonemeSimilarity(checkpoint=str(dirs["bin"]), device="cpu")
    jl = jlps.LevenshteinPhonemeSimilarity(checkpoint=str(dirs["bin"]))
    ref = _wav(FS)[0]
    est = (ref + 0.2 * np.random.default_rng(4).standard_normal(ref.shape)).astype(np.float32)
    for x in (ref, est):
        s = pl.phoneme_predictor(x)
        assert s == jl.phoneme_predictor(x) and s
    assert pl(est, ref) == jl(est, ref)

    repo = tmp_path / "models--facebook--wav2vec2-lv-60-espeak-cv-ft"
    (repo / "snapshots").mkdir(parents=True)
    (repo / "snapshots" / "main").symlink_to(dirs["safetensors"])
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    row = pmetrics.Metrics(["lps", "si-sdr"], device="cpu")(FS, est, ref)
    assert row["lps"] == pl(est, ref)
    got = pmetrics.EvalMetrics(lps=True, dnsmos=False, device="cpu")(est[None, None],
                                                                      ref[None, None])
    assert got["lps"] == row["lps"]


# ------------------------------------------------------------ not in the state
def test_wav2vec2_stays_out_of_the_lora_state(tiny):
    """A UniverseLoRA with the phoneme loss has the same ``state_dict``
    keys and trainable tensors as one without; no wav2vec2 tensor reaches
    the optimizer; a deep copy (validation's EMA copy) shares the frozen
    model instead of copying it."""
    from open_universe_tpu_torch.configs.registry import instantiate_trainable
    from open_universe_tpu_torch.configs.resolve import compose
    from open_universe_tpu_torch.models.universe_lora import UniverseLoRA
    from open_universe_tpu_torch.train.trainer import make_train_step
    from test_torch_validate import NARROW

    port = tiny[1]
    base = instantiate_trainable(compose(CONFIG_DIR, NARROW)["model"])
    lcfg = compose(CONFIG_DIR, ["experiment=universepp_lora_finetune", "model.lora_rank=2"])
    kw = {k: v for k, v in lcfg["model"].items() if k not in ("_target_", "model")}
    assert kw["losses"]["phonemeloss"]["kwargs"]["_target_"].endswith("PhonemeCTCLoss")
    kw["losses"]["phonemeloss"]["kwargs"]["model"] = port
    with_ph = UniverseLoRA(model=copy.deepcopy(base), **kw)
    kw["losses"] = {**kw["losses"], "phonemeloss": None}
    without = UniverseLoRA(model=copy.deepcopy(base), **kw)
    assert set(with_ph.losses_func) == {"multires_l1", "phonemeloss"}
    assert set(with_ph.state_dict()) == set(without.state_dict())
    assert [n for n, p in with_ph.named_parameters() if p.requires_grad] == \
        [n for n, p in without.named_parameters() if p.requires_grad]
    step = make_train_step(with_ph, 10)
    in_opt = {id(p) for g in step.opt.param_groups for p in g["params"]}
    assert in_opt and not in_opt & {id(p) for p in port.parameters()}
    clone = copy.deepcopy(with_ph)
    assert clone.losses_func["phonemeloss"].phoneme_predictor.model is port
