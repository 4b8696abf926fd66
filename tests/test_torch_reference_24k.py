"""The port against the benchmark's plain reference (``benchmark/reference``,
float32 PyTorch, no kernel of the port) at UNIVERSE++ 24 kHz's shapes on
the CPU: rate factors 2-3-5-8 at 24 kHz, weight norm and the score
network's low-pass, at a narrow width.  The same seeded checkpoint is loaded
by the port's ``load_model`` (EMA, weight-norm folding) and folded by the
reference; the same mix and draws go in, at a length that is not a multiple
of the total downsampling, 240."""
import contextlib
import json
from pathlib import Path

import pytest
import torch

from benchmark.common import program, weights
from benchmark.reference.fold import fold

CONFIG = Path(__file__).resolve().parents[1] / "benchmark/tests/data/configs/tiny_pp_24k.json"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    more oversubscribe the cores the other test workers use."""
    try:
        from threadpoolctl import threadpool_limits
        blas = threadpool_limits(1)  # numpy's BLAS too
    except ImportError:
        blas = contextlib.nullcontext()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with blas:
        yield
    torch.set_num_threads(n)


def test_port_matches_the_plain_reference_at_24k_shapes():
    cfg = json.loads(CONFIG.read_text())["model"]
    assert cfg["fs"] == 24000 and cfg["score_model"]["rate_factors"] == [2, 3, 5, 8]
    state, shadow = weights.draw(cfg, 2**31 + 13, "cpu")
    model = program.load(cfg, state, shadow, "cpu")
    assert model.tot_ds == 240
    ref = fold(cfg, state, shadow)
    g = torch.Generator().manual_seed(6)
    n = 24037
    mix = torch.randn(2, n, generator=g) * 0.1
    noise = [torch.randn(2, n + 240 - n % 240, 1, generator=g) for _ in range(2)]
    got = model.enhance(mix, noise=noise, n_steps=2)
    want = ref.enhance(mix, noise, 2)
    assert got.shape == want.shape == (2, n)
    # float32 on both sides, the same operations in another order
    assert float((got - want).norm() / want.norm()) < 1e-6
