"""The harness as data, the import guard, and whole runs on the CPU at a
narrow width: a sound run is correct, each planted fault of the timed path
is not, and a cell, a mix and a metric added as files are found without an
edit."""
import json
import shutil

import pytest

from benchmark import run as bench_run
from benchmark.common import harness, jaxguard

from .conftest import DATA, ROOT

SERVE, OFFLINE = "universepp_16k.serve", "universe_16k.offline"
SEED = 2**31 + 5  # larger than 32 signed bits hold


def test_jax_guard_compares_whole_top_level_names():
    assert jaxguard.loaded(["jax.numpy", "os"]) == ["jax"]
    assert jaxguard.loaded(["open_universe_tpu.models.universe"]) == ["open_universe_tpu"]
    assert jaxguard.loaded(["flax.linen", "jaxlib.xla_client"]) == ["flax", "jaxlib"]
    assert jaxguard.loaded(["open_universe_tpu_torch.bin.serve", "jaxtyping", "numpy"]) == []


def test_benchmark_json_names_files_that_exist():
    spec = harness.Spec.load()
    for w in spec.bench["workloads"]:
        cfg, mix = spec.config(w["config"]), spec.traffic(w["traffic"])
        spec.driver(mix["driver"])
        assert cfg["model"]["_target_"]
        names = {m["name"] for m in spec.metrics(w["name"], False)}
        assert "setup_s" in names and len(names) >= 2
        for m in spec.metrics(w["name"], False) + spec.metrics(w["name"], True):
            assert callable(spec.reader(m["name"]))
        layer = spec.metrics(w["name"], True)
        assert layer and all(m["moves"] in names for m in layer)


def _run(spec, workload, seconds, **extra):
    return bench_run.run_cell(spec, workload, SEED, seconds, device="cpu", **extra)


@pytest.mark.parametrize("workload,seconds", [(SERVE, 3.0), (OFFLINE, 2.0)])
def test_sound_run_is_correct(tiny_spec, workload, seconds, capsys):
    assert bench_run.main(["--workload", workload, "--seed", str(SEED), "--seconds",
                           str(seconds), "--trace", "0"], device="cpu", spec=tiny_spec) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert list(line)[-1] == "compared"
    assert set(line["metrics"]) == {m["name"] for m in tiny_spec.metrics(workload, False)}
    assert err.strip().splitlines()[-1].startswith("compared ")


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("workload,seconds", [(SERVE, 2.0), (OFFLINE, 1.0)])
def test_planted_fault_is_not_correct(tiny_spec, workload, seconds, fault):
    run = _run(tiny_spec, workload, seconds, fault=fault)
    assert not run.correct, run.compared


def test_cell_mix_and_metric_added_as_files(tmp_path, tiny_spec):
    for d in ("configs", "traffic", "cells"):
        shutil.copytree(DATA / d, tmp_path / d)
    shutil.copytree(ROOT / "benchmark" / "drivers", tmp_path / "drivers")
    shutil.copytree(ROOT / "benchmark" / "metrics", tmp_path / "metrics")
    mix = json.loads((DATA / "traffic" / "tiny_offline.json").read_text())
    mix["rows"] = 2
    (tmp_path / "traffic" / "tiny_offline_2.json").write_text(json.dumps(mix))
    shutil.copy(DATA / "configs" / "tiny_pp.json", tmp_path / "configs" / "tiny_pp_b.json")
    (tmp_path / "cells" / "tiny_pp_b.offline_2.json").write_text('{"rel_err_limit": 0.01}')
    (tmp_path / "metrics" / "calls.offline_new.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    bench = json.loads(json.dumps(tiny_spec.bench))
    bench["workloads"].append({"name": "tiny_pp_b.offline_2", "config": "tiny_pp_b",
                               "traffic": "tiny_offline_2", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "calls.offline_new", "unit": "calls", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny_pp_b.offline_2"]})
    spec = harness.Spec(bench, bench_dir=tmp_path, data_dir=tmp_path)
    run = _run(spec, "tiny_pp_b.offline_2", 1.0)
    assert run.correct and run.calls[0].rows == 2
    line = bench_run.result_line(spec, "tiny_pp_b.offline_2", run, False, {})
    assert line["metrics"]["calls.offline_new"]["value"] == len(run.calls)
    assert "enhance_audio_s_per_s" not in line["metrics"]
