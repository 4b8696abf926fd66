"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests marked ``card`` need an NVIDIA GPU; each decides inside the test and
skips without one."""
import copy
import json
from pathlib import Path

import pytest

DATA = Path(__file__).resolve().parent / "data"
ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_spec():
    """BENCHMARK.json's metrics with a serving and a bulk cell on narrow
    configurations and short mixes under tests/data."""
    from benchmark.common import harness

    tiny = copy.deepcopy(json.loads((ROOT / "BENCHMARK.json").read_text()))
    tiny["workloads"] = [
        {"name": "universepp_16k.serve", "config": "tiny_pp", "traffic": "tiny_serve",
         "chips": 1, "why": "the serving driver at a narrow width"},
        {"name": "universe_16k.offline", "config": "tiny_plain", "traffic": "tiny_offline",
         "chips": 1, "why": "the bulk driver at a narrow width"}]
    tiny["end_to_end"].append({"name": "latency_p95_ms", "unit": "ms", "better": "lower",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["universepp_16k.serve"]})
    return harness.Spec(tiny, data_dir=DATA)
