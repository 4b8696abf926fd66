"""The lower-precision control on the card at each cell's own size: the
program with its bf16 networks switched on must not come out correct, on
three seeds."""
import pytest

from benchmark import run as bench_run
from benchmark.common import harness


@pytest.mark.card
@pytest.mark.parametrize("workload,seconds", [("universe_16k.offline", 4.0),
                                              ("universepp_16k.offline", 4.0)])
def test_bf16_control_is_not_correct(workload, seconds):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec = harness.Spec.load()
    for k, seed in enumerate((301, 302, 303)):
        run = bench_run.run_cell(spec, workload, seed, seconds, control=True, precompile=k == 0)
        assert not run.correct, run.compared
