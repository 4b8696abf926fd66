"""The port's metrics (``open_universe_tpu_torch/metrics/``) and eval CLIs
(``bin/eval_metrics.py``, ``bin/make_table.py``) against the JAX package's,
on the CPU, on seeded signals of 1-2 s.

Tolerances: LSD (torch against jax.numpy, float32) <= 1e-5 relative; the
numpy modules (SI-SDR, SDR, STOI, ESTOI, P.862, loudness) <= 1e-9; the
ONNX executor against the JAX package's and against torch on graphs minted
with ``torch.onnx.export`` as ``tests/test_onnx_exec.py`` mints them.
"""
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from open_universe_tpu import metrics as jmetrics  # noqa: E402
from open_universe_tpu.bin import eval_metrics as jeval  # noqa: E402
from open_universe_tpu.bin import make_table as jtable  # noqa: E402
from open_universe_tpu.metrics import loudness as jloud  # noqa: E402
from open_universe_tpu.metrics import lps as jlps  # noqa: E402
from open_universe_tpu.metrics import onnx_exec as jonnx  # noqa: E402
from open_universe_tpu.metrics import p862 as jp862  # noqa: E402
from open_universe_tpu.metrics import wer as jwer  # noqa: E402
from open_universe_tpu_torch import metrics as pmetrics  # noqa: E402
from open_universe_tpu_torch.bin import eval_metrics as peval  # noqa: E402
from open_universe_tpu_torch.bin import make_table as ptable  # noqa: E402
from open_universe_tpu_torch.metrics import loudness as ploud  # noqa: E402
from open_universe_tpu_torch.metrics import lps as plps  # noqa: E402
from open_universe_tpu_torch.metrics import onnx_exec as ponnx  # noqa: E402
from open_universe_tpu_torch.metrics import p862 as pp862  # noqa: E402
from open_universe_tpu_torch.metrics import wer as pwer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FS = 16000
NUMPY_TOL = 1e-9
LSD_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The metrics run on single clips: one intra-op thread for torch and
    for numpy's BLAS (P.862's matrix products) keeps them from
    oversubscribing the cores the other test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def speech_like(seconds, seed, snr_noise=0.03):
    """(clean, noisy) float32: a modulated harmonic tone with pauses."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * FS)) / FS
    f0 = rng.uniform(110, 240)
    clean = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
    clean = 0.1 * clean * np.clip(np.sin(2 * np.pi * 2.5 * t), 0.05, None)
    noisy = clean + snr_noise * rng.standard_normal(t.shape)
    return clean.astype(np.float32), noisy.astype(np.float32)


def _diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# ----------------------------------------------------------------- modules
@pytest.mark.parametrize("scale_invariant", [False, True])
def test_lsd_matches_jax(scale_invariant, record_property):
    import jax.numpy as jnp

    pairs = [speech_like(s, i) for i, s in enumerate((1.0, 1.0, 1.0))]
    est = np.stack([n for _, n in pairs])[:, None]
    ref = np.stack([c for c, _ in pairs])[:, None]
    for kw in ({}, {"n_fft": 512, "hop_length": 128, "db": False}):
        want = np.asarray(jmetrics.log_spectral_distance(
            jnp.asarray(est), jnp.asarray(ref), scale_invariant=scale_invariant, **kw))
        got = pmetrics.log_spectral_distance(
            torch.from_numpy(est), torch.from_numpy(ref),
            scale_invariant=scale_invariant, **kw).numpy()
        assert got.shape == want.shape == (3, 1)
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        record_property("max_rel_diff", rel)
        assert rel <= LSD_TOL


def test_bss_stoi_loudness_match_jax(record_property):
    """The numpy copies compute what the JAX package's modules compute."""
    worst = 0.0
    for seed, seconds in ((0, 1.0), (1, 1.5)):
        clean, noisy = speech_like(seconds, seed)
        for fn_p, fn_j in ((pmetrics.si_sdr, jmetrics.si_sdr), (pmetrics.sdr, jmetrics.sdr)):
            worst = max(worst, _diff(fn_p(clean, noisy), fn_j(clean, noisy)))
        assert pmetrics.si_sdr(clean, noisy, zero_mean=True) == jmetrics.si_sdr(
            clean, noisy, zero_mean=True)
        for ext in (False, True):
            worst = max(worst, _diff(pmetrics.stoi(clean, noisy, FS, extended=ext),
                                     jmetrics.stoi(clean, noisy, FS, extended=ext)))
        for fs in (FS, 24000):
            worst = max(worst, _diff(ploud.loudness(noisy, fs), jloud.loudness(noisy, fs)))
    assert ploud.loudness(np.zeros(100), FS) == float("-inf")
    record_property("max_abs_diff", worst)
    assert worst <= NUMPY_TOL


@pytest.mark.parametrize("mode", ["wb", "nb"])
def test_p862_matches_jax(mode, record_property):
    clean, noisy = speech_like(1.5, 3)
    got = pp862.pesq(FS, clean, noisy, mode)
    want = jp862.pesq(FS, clean, noisy, mode)
    record_property("max_abs_diff", float(abs(got - want)))
    assert abs(got - want) <= NUMPY_TOL and 1.0 < got < 4.7
    assert pp862.resolve_pesq()[1] == jp862.resolve_pesq()[1]
    # the identical-signal fixed point
    assert abs(pp862.pesq(FS, clean, clean, mode) - jp862.pesq(FS, clean, clean, mode)) <= 1e-12


def test_wer_matches_jax():
    refs = ["The cat sat on the mat.", "hello <ignore/> world", ["a", "b", "c"]]
    hyps = ["the cat sat on a mat", "hello big wide world", ["a", "c"]]
    for wc in (None, "<ignore/>"):
        assert pwer.wer(refs, hyps, wildcard=wc) == jwer.wer(refs, hyps, wildcard=wc)
        for r, h in zip(refs, hyps):
            assert pwer.word_edit_distance(r, h, wc) == jwer.word_edit_distance(r, h, wc)


class _StubPhonemes:
    """A stand-in for LPS's wav2vec2 predictor (both packages build it by
    name): one phoneme per 0.1 s, by the chunk's energy."""

    sr = FS

    def __init__(self, checkpoint=None, device=None):
        pass

    def __call__(self, audio):
        chunks = np.asarray(audio, np.float64)[: len(audio) // 1600 * 1600].reshape(-1, 1600)
        return " ".join("a" if e > 1e-3 else "b" for e in np.mean(chunks ** 2, axis=1))


def test_metrics_dispatcher_matches_jax(record_property, monkeypatch):
    """``Metrics`` (every metric without a download or weights) on one clip
    and on a batch of two: the same keys; LSD within 1e-5 relative, the rest
    within 1e-9.  A metric that fails on a clip drops only itself.  ``lps``
    on a stand-in predictor equals JAX's."""
    names = ["pesq-wb", "pesq-nb", "stoi", "stoi-ext", "lsd", "si-lsd", "sdr", "si-sdr"]
    clean, noisy = speech_like(1.2, 4)
    clean2, noisy2 = speech_like(1.0, 5)
    pm, jm = pmetrics.Metrics(names), jmetrics.Metrics(names)
    worst = {}
    for args in ((FS, noisy, clean),
                 (FS, np.stack([noisy[:FS], noisy2]), np.stack([clean[:FS], clean2]))):
        got, want = pm(*args), jm(*args)
        got, want = (got, want) if isinstance(got, list) else ([got], [want])
        for g, w in zip(got, want):
            assert set(g) == set(w) == set(names)
            for k in names:
                d = abs(g[k] - w[k]) / (abs(w[k]) if "lsd" in k else 1.0)
                worst[k] = max(worst.get(k, 0.0), d)
                assert d <= (LSD_TOL if "lsd" in k else NUMPY_TOL), (k, g[k], w[k])
    record_property("max_diff", {k: float(v) for k, v in worst.items()})
    # 0.1 s: PESQ fails, the other metrics stay (per-metric isolation)
    short_p = pm(FS, noisy[:1600], clean[:1600])
    short_j = jm(FS, noisy[:1600], clean[:1600])
    assert set(short_p) == set(short_j) and "pesq-wb" not in short_p
    # skip-list by the keys a metric emits
    assert pmetrics.Metrics.remaining(["dnsmos", "sdr"], ["OVRL_raw", "SIG_raw", "BAK_raw",
                                                          "OVRL", "SIG", "BAK"]) == ["sdr"]
    monkeypatch.setattr(plps, "PhonemePredictor", _StubPhonemes)
    monkeypatch.setattr(jlps, "PhonemePredictor", _StubPhonemes)
    assert pmetrics.LevenshteinPhonemeSimilarity is plps.LevenshteinPhonemeSimilarity
    assert pmetrics.Metrics(["lps"])(FS, noisy, clean) == jmetrics.Metrics(["lps"])(FS, noisy,
                                                                                   clean)


def test_eval_metrics_class_matches_jax(caplog, record_property, monkeypatch):
    """``EvalMetrics`` (validation's metric suite): the same keys as the
    JAX package's; DNSMOS, whose weights are not in the repo, is skipped
    with a warning by both; LSD on torch tensors, where validation hands
    them; ``lps=True`` on a stand-in predictor as JAX's."""
    import logging

    pairs = [speech_like(1.0, 6), speech_like(1.0, 7)]
    est = np.stack([n for _, n in pairs])[:, None]
    ref = np.stack([c for c, _ in pairs])[:, None]
    with caplog.at_level(logging.WARNING):
        pe = pmetrics.EvalMetrics()
    assert pe._dnsmos is None and "DNSMOS unavailable" in caplog.text
    je = jmetrics.EvalMetrics()
    got, want = pe(torch.from_numpy(est), torch.from_numpy(ref)), je(est, ref)
    assert set(got) == set(want) == {"lsd", "pesq"}
    assert abs(got["lsd"] - want["lsd"]) <= LSD_TOL * abs(want["lsd"])
    assert abs(got["pesq"] - want["pesq"]) <= NUMPY_TOL
    record_property("lsd_rel", float(abs(got["lsd"] - want["lsd"]) / abs(want["lsd"])))
    assert pe(est[:, 0], ref[:, 0]) == got  # (B, T) arrays
    monkeypatch.setattr(plps, "PhonemePredictor", _StubPhonemes)
    monkeypatch.setattr(jlps, "PhonemePredictor", _StubPhonemes)
    assert pmetrics.EvalMetrics(lps=True, dnsmos=False)(est, ref)["lps"] == \
        jmetrics.EvalMetrics(lps=True, dnsmos=False)(est, ref)["lps"]
    # 24 kHz audio is scored at 16 kHz, as the JAX package does
    got24 = pmetrics.EvalMetrics(audio_fs=24000, dnsmos=False)(est, ref)
    want24 = jmetrics.EvalMetrics(audio_fs=24000, dnsmos=False)(est, ref)
    assert abs(got24["pesq"] - want24["pesq"]) <= NUMPY_TOL


class _StubSession:
    """onnxruntime's ``run`` on a fixed function of the features."""

    def run(self, _names, feeds):
        x = next(iter(feeds.values()))
        m = float(np.mean(np.abs(x)))
        if "rater_embed" in feeds:
            return [np.asarray([[2.0 + m + 0.01 * float(feeds["rater_embed"].sum())]],
                               np.float32)]
        return [np.asarray([[3.0 + m, 2.5 - m, 3.5 * m]], np.float32)]


def test_dnsmos_plcmos_pipelines_match_jax():
    """The DNSMOS windowing and calibration and the PLCMOS features, on a
    stub session (the official weights are not in the repo): the port's
    wrappers give the JAX package's numbers; without weights they raise
    FileNotFoundError, as the JAX package's do."""
    from open_universe_tpu.metrics.dnsmos import Compute_DNSMOS as JD
    from open_universe_tpu.metrics.plcmos import PLCMOSEstimator as JP
    from open_universe_tpu_torch.metrics.dnsmos import Compute_DNSMOS as PD
    from open_universe_tpu_torch.metrics.plcmos import PLCMOSEstimator as PP

    _, noisy = speech_like(1.3, 8)
    for personalized in (False, True):
        got = PD(personalized_MOS=personalized, session=_StubSession())(noisy, FS)
        want = JD(personalized_MOS=personalized, session=_StubSession())(noisy, FS)
        assert got == want
    assert PD(session=_StubSession())(noisy[::2], 8000) == JD(
        session=_StubSession())(noisy[::2], 8000)
    assert PP(session=_StubSession()).run(noisy, FS) == JP(session=_StubSession()).run(noisy, FS)
    with pytest.raises(FileNotFoundError):
        PD()
    with pytest.raises(FileNotFoundError):
        PP()


# ------------------------------------------------------------- ONNX executor
def _export(module, args, opset=12):
    """torch.onnx.export to bytes without the ``onnx`` package (as
    tests/test_onnx_exec.py does)."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda mb, co: mb
    try:
        buf = io.BytesIO()
        torch.onnx.export(module.eval(), args, buf, opset_version=opset, dynamo=False)
        return buf.getvalue()
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


class _ConvGruNet(torch.nn.Module):
    """The op families of the metric graphs: a dilated and strided Conv2d,
    MaxPool, LeakyReLU, a bidirectional GRU, Gemm, reductions and shape
    plumbing."""

    def __init__(self):
        super().__init__()
        self.c1 = torch.nn.Conv2d(1, 4, 3, padding=1, dilation=(2, 1))
        self.c2 = torch.nn.Conv2d(4, 6, (3, 3), stride=(1, 2), padding=(1, 0))
        self.pool = torch.nn.MaxPool2d((1, 2), stride=(1, 2))
        self.gru = torch.nn.GRU(6, 5, bidirectional=True)
        self.head = torch.nn.Linear(10, 3)

    def forward(self, x):  # (B, 1, H, W)
        h = torch.nn.functional.leaky_relu(self.c1(x), 0.1)
        h = self.pool(torch.relu(self.c2(h)))  # (B, 6, H, W')
        seq = h.mean(dim=3).permute(2, 0, 1)  # (H, B, 6)
        _, hn = self.gru(seq)
        out = self.head(torch.cat([hn[0], hn[1]], dim=-1))
        return torch.sigmoid(out) * 4.0 + torch.sqrt(out[:, :1] * out[:, :1] + 1.0) / 2.0


@pytest.mark.parametrize("opset", [11, 12])
def test_onnx_exec_matches_jax_and_torch(opset, record_property):
    torch.manual_seed(opset)
    net, x = _ConvGruNet(), torch.randn(2, 1, 12, 17)
    blob = _export(net, (x,), opset)
    ps, js = ponnx.OnnxSession(blob), jonnx.OnnxSession(blob)
    assert [i.name for i in ps.get_inputs()] == [i.name for i in js.get_inputs()]
    feed = {ps.get_inputs()[0].name: x.numpy()}
    (got,), (want,) = ps.run(None, feed), js.run(None, feed)
    np.testing.assert_array_equal(got, want)
    ref = net(x).detach().numpy()
    record_property("max_abs_diff_torch", _diff(got, ref))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    assert ponnx.parse_model(blob).opsets[""] == opset


def test_onnx_exec_fails_loudly_on_what_it_does_not_implement():
    """auto_pad SAME_*, integer Div and non-default GRU activations raise
    NotImplementedError (the JAX package's executor computes something
    else for them); VALID and float Div still run."""
    torch.manual_seed(0)
    net, x = _ConvGruNet(), torch.randn(1, 1, 12, 17)
    blob = _export(net, (x,))
    for op, attr, value in (("Conv", "auto_pad", b"SAME_UPPER"),
                            ("MaxPool", "auto_pad", b"SAME_LOWER"),
                            ("GRU", "activations", [b"Relu", b"Tanh", b"Relu", b"Tanh"])):
        sess = ponnx.OnnxSession(blob)
        feed = {sess.get_inputs()[0].name: x.numpy()}
        node = next(n for n in sess.model.graph.nodes if n.op_type == op)
        node.attrs[attr] = value
        with pytest.raises(NotImplementedError, match=attr if op != "GRU" else "activations"):
            sess.run(None, feed)
    sess = ponnx.OnnxSession(blob)
    for n in sess.model.graph.nodes:
        if n.op_type == "GRU":
            n.attrs["activations"] = [b"Sigmoid", b"Tanh", b"Sigmoid", b"Tanh"]
    np.testing.assert_allclose(sess.run(None, feed)[0], net(x).detach().numpy(),
                               atol=1e-5, rtol=1e-5)

    def div_graph(dtype):
        g = ponnx.Graph(nodes=[ponnx.Node("Div", ["a", "b"], ["y"], {})],
                        initializers={"b": np.asarray([2, 4], dtype)},
                        inputs=[("a", [2])], outputs=[("y", [2])])
        sess = ponnx.OnnxSession.__new__(ponnx.OnnxSession)
        sess.model = ponnx.Model(g)
        sess._inputs = [ponnx._IOInfo("a", [2])]
        sess._outputs = [ponnx._IOInfo("y", [2])]
        return sess

    with pytest.raises(NotImplementedError, match="integer Div"):
        div_graph(np.int64).run(None, {"a": np.asarray([7, -7], np.int64)})
    out = div_graph(np.float32).run(None, {"a": np.asarray([7, -7], np.float32)})[0]
    np.testing.assert_array_equal(out, [3.5, -1.75])


# ------------------------------------------------------------------- CLIs
def _write_folder(root, n=3, seconds=1.0):
    from scipy.io import wavfile

    for d in ("clean", "enh"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        clean, noisy = speech_like(seconds + 0.25 * i, 20 + i)
        wavfile.write(root / "clean" / f"u{i}.wav", FS, (clean * 32767).astype(np.int16))
        wavfile.write(root / "enh" / f"u{i}.wav", FS, (noisy * 32767).astype(np.int16))


def _close_json(got, want, path=""):
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close_json(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, float):
        tol = LSD_TOL * abs(want) if "lsd" in path else NUMPY_TOL
        assert abs(got - want) <= tol, (path, got, want)
    else:
        assert got == want, path


def test_eval_metrics_and_make_table_match_jax(tmp_path):
    """Both CLIs on copies of one folder: the same per-file JSON and summary
    JSON (LSD within 1e-5 relative), the same ``.bak`` rotation, the same
    rerun (a scored file is skipped, a new metric is added to every file),
    and the same table text."""
    _write_folder(tmp_path / "src")
    runs = {}
    for side, module in (("port", peval), ("jax", jeval)):
        root = tmp_path / side
        shutil.copytree(tmp_path / "src", root)
        enh = root / "enh"
        assert module.main([str(enh), "--ref_path", str(root / "clean"),
                            "--metrics", "pesq-wb", "si-sdr", "lsd"]) == 0
        first = json.loads((root / "enh.json").read_text())
        # rerun with one more metric: the scored ones stay, stoi is added
        assert module.main([str(enh), "--ref_path", str(root / "clean"),
                            "--metrics", "pesq-wb", "si-sdr", "lsd", "stoi"]) == 0
        runs[side] = {
            "first": first,
            "results": json.loads((root / "enh.json").read_text()),
            "summary": json.loads((root / "enh_summary.json").read_text()),
            "bak": sorted(p.name for p in root.glob("enh*.bak*")),
            "bak_results": json.loads((root / "enh.json.bak").read_text()),
        }
    p, j = runs["port"], runs["jax"]
    _close_json(p["results"], j["results"])
    _close_json(p["summary"], j["summary"])
    assert p["bak"] == j["bak"] == ["enh.json.bak", "enh_summary.json.bak"]
    _close_json(p["bak_results"], j["bak_results"])
    assert set(p["results"]["u0"]) == {"pesq-wb", "si-sdr", "lsd", "stoi"}
    assert all(p["results"][k][m] == p["first"][k][m]
               for k in p["first"] for m in p["first"][k])
    assert p["summary"]["number"] == 3 and p["summary"]["pesq_conformant"] is False

    # the summary read back into a table: the same text from both
    args = ["--results", str(tmp_path / "jax" / "enh_summary.json"),
            str(tmp_path / "port" / "enh_summary.json"), "--labels", "jax", "port",
            "--metrics", "pesq-wb", "si-sdr", "stoi"]
    texts = {}
    for side, module in (("port", ptable), ("jax", jtable)):
        buf = io.StringIO()
        stdout, sys.stdout = sys.stdout, buf
        try:
            assert module.main(args) == 0
        finally:
            sys.stdout = stdout
        texts[side] = buf.getvalue()
    assert texts["port"] == texts["jax"] and "in-house P.862" in texts["port"]


def test_eval_metrics_workers_match_jax(tmp_path, capsys):
    """``bin/eval_metrics.py`` with two worker processes (spawned; each
    builds its own ``Metrics``): each file's row equals the JAX package's
    ``Metrics`` on it, and the summary printed is the one written."""
    from open_universe_tpu.data.audio import load_audio

    _write_folder(tmp_path, n=2)
    assert peval.main([str(tmp_path / "enh"), "--ref_path", str(tmp_path / "clean"),
                       "--metrics", "si-sdr", "stoi-ext", "--workers", "2",
                       "--force-workers"]) == 0
    summary = json.loads((tmp_path / "enh_summary.json").read_text())
    assert summary["number"] == 2 and {"si-sdr", "stoi-ext"} <= set(summary)
    assert json.loads(capsys.readouterr().out) == summary
    results = json.loads((tmp_path / "enh.json").read_text())
    want = jmetrics.Metrics(["si-sdr", "stoi-ext"])
    for name, row in results.items():
        deg, _ = load_audio(tmp_path / "enh" / f"{name}.wav")
        ref, _ = load_audio(tmp_path / "clean" / f"{name}.wav")
        _close_json(row, want(FS, deg[0], ref[0]))
