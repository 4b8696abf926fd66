"""The plain reference against the port at a narrow width, on the CPU:
the same drawn checkpoint, loaded by the port's ``load_model`` (EMA and
weight-norm folding) and folded by the reference, the same input and draws."""
import json

import pytest
import torch

from benchmark.common import program, weights
from benchmark.reference.fold import fold

from .conftest import DATA


@pytest.mark.parametrize("name", ["tiny_pp", "tiny_plain"])
def test_reference_matches_the_port(name):
    cfg = json.loads((DATA / "configs" / f"{name}.json").read_text())["model"]
    state, shadow = weights.draw(cfg, 2**31 + 11, "cpu")
    model = program.load(cfg, state, shadow, "cpu")
    ref = fold(cfg, state, shadow)
    g = torch.Generator().manual_seed(5)
    mix = torch.randn(3, 16037, generator=g) * 0.1
    t_pad = 16037 + 160 - 16037 % 160
    noise = [torch.randn(3, t_pad, 1, generator=g) for _ in range(2)]
    got = model.enhance(mix, noise=noise, n_steps=2)
    want = ref.enhance(mix, noise, 2)
    assert got.shape == want.shape == (3, 16037)
    assert float((got - want).norm() / want.norm()) < 1e-6


def test_the_ema_shadow_and_the_folding_matter():
    """Raw weights are half the shadow: a model built from them differs."""
    cfg = json.loads((DATA / "configs" / "tiny_pp.json").read_text())["model"]
    state, shadow = weights.draw(cfg, 7, "cpu")
    assert all(k.startswith(("_edm_model.", "condition_model.", "signal_decoupling_layer."))
               for k in state)
    assert len(shadow) == sum(1 for k in state if not k.endswith("sigma_block.freq"))
    ema = fold(cfg, state, shadow)
    raw = fold(cfg, state, [s * 0.5 for s in shadow])
    mix = torch.randn(1, 16000, generator=torch.Generator().manual_seed(1)) * 0.1
    noise = [torch.zeros(1, 16160, 1)] * 2
    assert not torch.allclose(ema.enhance(mix, noise, 2), raw.enhance(mix, noise, 2))
