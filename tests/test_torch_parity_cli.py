"""The last modules of the PyTorch port against the JAX package, on the CPU:
the quality-parity CLI (``bin/parity.py``: the published rows, the report
and its delta direction, the table; end to end on a synthetic checkpoint
and synthetic wavs, as JAX's ``tests/test_parity_harness.py`` runs it),
the resample CLI (``bin/resample.py`` and its ``prepare/resample.py``
alias: the files JAX's writes, within one 16-bit step), the reference-path
aliases (``datasets``, ``inference_utils``, ``layers``, ``networks``) and
``utils/params.py`` with the ``utils`` exports.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from open_universe_tpu.bin import parity as jparity  # noqa: E402
from open_universe_tpu.bin import resample as jresample  # noqa: E402
from open_universe_tpu.utils import params as jparams  # noqa: E402
from open_universe_tpu_torch.bin import parity as pparity  # noqa: E402
from open_universe_tpu_torch.data.audio import load_audio, save_audio  # noqa: E402
from open_universe_tpu_torch.utils import params as pparams  # noqa: E402
from test_torch_cli import ckpt  # noqa: E402,F401  (the module's checkpoint fixture)

ROOT = Path(__file__).resolve().parents[1]
SUMMARIES = [
    {"number": 2, "si-sdr": 19.0, "lsd": 5.0, "pesq-wb": 3.0, "stoi-ext": 0.9},
    {"number": 1, "si-sdr": 1.0},
    {"number": 3},
    {"number": 4, "si-sdr": 18.624, "lsd": 4.867, "dnsmos-ovr": 3.3, "lps": 0.5},
]


def test_reference_rows_and_report_match_jax():
    """The published rows, build_report (values, delta direction, parity
    only when a metric was compared) and format_table, for summaries with
    metrics better, worse, equal and missing, against both rows."""
    assert pparity.REFERENCE_RESULTS == jparity.REFERENCE_RESULTS
    assert pparity._HIGHER_BETTER == jparity._HIGHER_BETTER
    assert pparity.DEFAULT_METRICS == jparity.DEFAULT_METRICS
    metrics = ["si-sdr", "pesq-wb", "stoi-ext", "lsd", "lps", "dnsmos-ovr"]
    for summary in SUMMARIES:
        for row in pparity.REFERENCE_RESULTS:
            want = jparity.build_report(summary, jparity.REFERENCE_RESULTS[row], metrics)
            got = pparity.build_report(summary, pparity.REFERENCE_RESULTS[row], metrics)
            assert got == want
            assert pparity.format_table(got) == jparity.format_table(want)
    rep = pparity.build_report(SUMMARIES[0], pparity.REFERENCE_RESULTS["plusplus"],
                               ["si-sdr", "lsd"])
    rows = {r["metric"]: r for r in rep["rows"]}
    assert rows["si-sdr"]["better"] is True and rows["lsd"]["better"] is False
    assert pparity.build_report({"number": 3}, {"si-sdr": 1.0}, ["si-sdr"])["parity"] is False


def test_parity_end_to_end_on_the_cpu(ckpt, tmp_path):  # noqa: F811
    """enhance (``--device cpu``, 2 steps) + eval_metrics + the report on a
    synthetic tree limited to 2 of 3 files: the report is written, every
    row finite with its delta, and a random tiny model has no parity."""
    fs = 16000
    noisy, clean = tmp_path / "noisy", tmp_path / "clean"
    noisy.mkdir()
    clean.mkdir()
    rng = np.random.default_rng(3)
    for i in range(3):
        t = int(0.4 * fs)
        c = (0.1 * np.sin(2 * np.pi * (200 + 40 * i) * np.arange(t) / fs)).astype(np.float32)
        save_audio(clean / f"p{i}.wav", c, fs)
        save_audio(noisy / f"p{i}.wav", c + 0.05 * rng.standard_normal(t).astype(np.float32),
                   fs)
    out = tmp_path / "run"
    assert pparity.main(["--model", str(ckpt), "--noisy-dir", str(noisy), "--clean-dir",
                         str(clean), "--output", str(out), "--metrics", "si-sdr", "lsd",
                         "--n-steps", "2", "--limit", "2", "--bucket-seconds", "0.5",
                         "--device", "cpu"]) == 0
    report = json.loads((out / "parity_report.json").read_text())
    assert report["n_files"] == 2 and report["n_compared"] == 2
    assert report["parity"] is False
    assert {r["metric"] for r in report["rows"]} == {"si-sdr", "lsd"}
    for row in report["rows"]:
        assert np.isfinite(row["ours"]) and "delta" in row and "better" in row
    summary = json.loads((out / "enhanced_summary.json").read_text())
    assert report["rows"] == jparity.build_report(
        summary, jparity.REFERENCE_RESULTS["plusplus"], ["si-sdr", "lsd"])["rows"]
    assert len(list((out / "enhanced").rglob("*.wav"))) == 2


def test_resample_cli_matches_jax(tmp_path):
    """``python -m open_universe_tpu_torch.bin.resample`` on a tree of wavs
    at 8, 16 (copied through) and 44.1 kHz, mono and stereo, to 16 kHz: the
    same relative paths, rates and lengths as JAX's, samples within one
    16-bit step; ``prepare.resample`` is the same entry point."""
    src = tmp_path / "in"
    rng = np.random.default_rng(4)
    for name, fs, ch in (("a.wav", 8000, 1), ("sub/b.wav", 44100, 2), ("c.wav", 16000, 1)):
        t = int(0.3 * fs)
        x = (0.2 * np.sin(2 * np.pi * 440 * np.arange(t) / fs)
             + 0.05 * rng.standard_normal((ch, t))).astype(np.float32)
        (src / name).parent.mkdir(parents=True, exist_ok=True)
        save_audio(src / name, x[0] if ch == 1 else x, fs)
    out = tmp_path / "out"
    subprocess.run([sys.executable, "-m", "open_universe_tpu_torch.bin.resample", str(src),
                    str(out), "--fs", "16000", "--workers", "1"], cwd=ROOT, check=True,
                   capture_output=True)
    for p in sorted(src.rglob("*.wav")):
        want_path = tmp_path / "jax" / p.relative_to(src)
        jresample._one((p, want_path, 16000))
        got, fs_got = load_audio(out / p.relative_to(src))
        want, fs_want = load_audio(want_path)
        assert fs_got == fs_want == 16000 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1.0 / 32767, rtol=0)
    from open_universe_tpu_torch.bin import resample as presample
    from open_universe_tpu_torch.prepare import resample as prep

    assert prep.main is presample.main


def test_aliases_export_what_jax_exports():
    """Each reference-path alias module exports the names JAX's does, bound
    to the port's own objects (no JAX class)."""
    import importlib

    for name in ("datasets", "inference_utils", "layers", "networks", "networks.universe",
                 "prepare", "prepare.resample"):
        jmod = importlib.import_module(f"open_universe_tpu.{name}")
        pmod = importlib.import_module(f"open_universe_tpu_torch.{name}")
        public = [k for k, v in vars(jmod).items() if not k.startswith("_") and (
            getattr(v, "__module__", None) or getattr(v, "__name__", "")).startswith(
                "open_universe_tpu.")]
        assert public, name
        for k in public:
            obj = getattr(pmod, k)
            where = getattr(obj, "__module__", None) or obj.__name__
            assert where.startswith("open_universe_tpu_torch"), (name, k)
    from open_universe_tpu_torch.networks.universe import UniverseGAN
    from open_universe_tpu_torch.models.universe_gan import UniverseGAN as Direct

    assert UniverseGAN is Direct


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"score_model": {"conv": {"weight": rng.standard_normal((3, 4, 5)),
                                     "bias": rng.standard_normal(5)},
                            "gru": {"weight_ih_l0": rng.standard_normal((6, 3))}},
            "condition_model": {"lin": {"weight": rng.standard_normal((2, 7))}},
            "x": rng.standard_normal(4)}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def test_params_utils_match_jax():
    """count_parameters and count_parameters_per_level (levels 1-3) on the
    same tree (a dict of tensors; a module's parameters too), pad_dim_right,
    at_least_f32's dtypes and to_device against the JAX package's."""
    tree = _tree()
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    assert pparams.count_parameters(_to_torch(tree)) == jparams.count_parameters(jtree)
    for level in (1, 2, 3):
        assert (pparams.count_parameters_per_level(_to_torch(tree), level)
                == jparams.count_parameters_per_level(jtree, level))
    lin = torch.nn.Linear(3, 4)
    assert pparams.count_parameters(lin) == 16
    assert pparams.count_parameters_per_level(lin, 1) == {"": 16, "weight": 12, "bias": 4}
    a, x = np.arange(6.0).reshape(2, 3), np.zeros((2, 3, 4, 5))
    np.testing.assert_array_equal(
        pparams.pad_dim_right(torch.from_numpy(a), torch.from_numpy(x)).numpy(),
        np.asarray(jparams.pad_dim_right(jnp.asarray(a), jnp.asarray(x))))
    with pytest.raises(ValueError):
        pparams.pad_dim_right(torch.zeros(3), torch.zeros(2, 3))
    for dt, want in ((torch.bfloat16, torch.float32), (torch.float16, torch.float32),
                     (torch.float32, torch.float32)):
        assert pparams.at_least_f32(torch.zeros(2, dtype=dt)).dtype == want
        assert (str(jparams.at_least_f32(jnp.zeros(2, getattr(jnp, str(dt)[6:]))).dtype)
                == str(want)[6:])
    # float64 stays (JAX runs here without x64, so only the port's side)
    assert pparams.at_least_f32(torch.zeros(2, dtype=torch.float64)).dtype == torch.float64
    nested = {"a": [torch.ones(2), (torch.zeros(1), 3)], "b": np.ones(2)}
    got = pparams.to_device(nested, "cpu", to_numpy=True)
    assert isinstance(got["a"][0], np.ndarray) and isinstance(got["a"][1], tuple)
    assert got["a"][1][1] == 3
    assert isinstance(pparams.to_device(np.ones(2), "meta"), torch.Tensor)
    with pytest.raises(ValueError):
        pparams.to_device(nested, "cuda", to_numpy=True)


def test_utils_exports_match_jax():
    """``open_universe_tpu_torch.utils`` exports JAX's ``utils`` names, the
    clippers and grad_norm lazily from ``train/optim``."""
    import open_universe_tpu.utils as jutils
    import open_universe_tpu_torch.utils as putils
    from open_universe_tpu_torch.train import optim

    names = [k for k in vars(jutils) if not k.startswith("_") and callable(vars(jutils)[k])
             and vars(jutils)[k].__module__.startswith("open_universe_tpu.utils")]
    assert names
    for k in names + ["AutoClipper", "FixedClipper", "grad_norm"]:
        assert getattr(putils, k).__module__.startswith("open_universe_tpu_torch"), k
    assert putils.grad_norm is optim.global_norm and putils.AutoClipper is optim.AutoClipper
    with pytest.raises(AttributeError):
        putils.not_a_name  # noqa: B018
