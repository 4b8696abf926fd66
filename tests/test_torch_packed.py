"""The kernel's rows entry (``fused_conv_chain_rows``, the JAX package's
lane-packed layout) in the PyTorch port, on the CPU: its plain version
against JAX ``fused_conv_chain_rows`` in interpret mode (2e-5), and the
wrapper's checks.  A ConvBlock never takes it: at every batch and width it
calls ``fused_conv_chain`` on (B, T, C), the same kernel on the same bytes.
``enhance`` against JAX's packed ``enhance`` is in
``tests/test_torch_serve.py``, on a loaded checkpoint.
"""
import numpy as np
import pytest
from threadpoolctl import threadpool_limits

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from open_universe_tpu.ops import pallas as pallas_config  # noqa: E402
from open_universe_tpu.ops.pallas.conv_block import (  # noqa: E402
    fused_conv_chain_rows as jax_fused_rows,
)
from open_universe_tpu_torch.nn.blocks import ConvBlock  # noqa: E402
from open_universe_tpu_torch.nn.layers import init_weights  # noqa: E402
from open_universe_tpu_torch.ops import kernels  # noqa: E402
from open_universe_tpu_torch.ops.kernels import conv_block  # noqa: E402
from open_universe_tpu_torch.utils.convert import fold_weight_norm  # noqa: E402

TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small tensors gain nothing from more, and
    more oversubscribe the cores the other test workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):  # numpy's BLAS too
        yield
    torch.set_num_threads(n)


def _draw(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _close(port, ref, atol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=0)


def _chain_weights(rng, c):
    def w(k):
        return (rng.uniform(-1, 1, (k, c, c)) / np.sqrt(k * c)).astype(np.float32)

    def b():
        return rng.uniform(-0.5, 0.5, (c,)).astype(np.float32)

    def a():
        return rng.uniform(0.0, 0.5, (1,)).astype(np.float32)

    return (w(5), b(), a(), w(3), b(), a(), w(3), b(), a())


# P = 4, 2 (the 24 kHz preset's C = 48, 96 lanes) and 1; 64-row tiles with
# a partial tail tile
@pytest.mark.parametrize("c,t", [(32, 480), (128, 96), (48, 200)])
def test_rows_plain_version_matches_pallas_rows_entry(rng, record_property, c, t):
    p = max(1, 128 // c)
    weights = _chain_weights(rng, c)
    h = _draw(rng, 2, t // p, p * c)
    nc, ic = _draw(rng, 2, 2 * c), _draw(rng, 2, t // p, p * c)
    saved = dict(pallas_config._STATE)
    pallas_config.enable(True, interpret=True)
    try:
        ref = jax.jit(lambda h, w, nc, ic: jax_fused_rows(
            h, p, c, *w, noise_cond=nc, input_cond_rows=ic, tile_target=64))(
            h, weights, nc, ic)
    finally:
        pallas_config._STATE.update(saved)
    got = conv_block.fused_conv_chain_rows_reference(
        _t(h), p, c, *map(_t, weights), noise_cond=_t(nc), input_cond_rows=_t(ic))
    for name, g, r in zip(("v", "cond_out"), got, ref):
        record_property(f"max_abs_diff_{name}", float(np.abs(g.numpy() - np.asarray(r)).max()))
        _close(g, r, TOL)


def test_rows_wrapper_checks_and_counts(rng):
    """On a CPU tensor the wrapper runs the plain version (no launch); it
    refuses a wrong pack factor, a lane count that is not P*C and
    non-contiguous rows."""
    c, p = 64, 2
    weights = [_t(w) for w in _chain_weights(rng, c)]
    h = _t(_draw(rng, 1, 9, p * c))
    before = dict(conv_block.launches)
    v, cond_out = conv_block.fused_conv_chain_rows(h, p, c, *weights)
    ref = conv_block.fused_conv_chain_reference(h.reshape(1, 18, c), *weights)
    np.testing.assert_array_equal(v.numpy(), ref[0].reshape(1, 9, p * c).numpy())
    np.testing.assert_array_equal(cond_out.numpy(), ref[1].reshape(1, 9, p * c).numpy())
    assert conv_block.launches == before
    with pytest.raises(ValueError, match="pack factor"):
        conv_block.fused_conv_chain_rows(h, 1, c, *weights)
    with pytest.raises(ValueError, match="lanes"):
        conv_block.fused_conv_chain_rows(h[..., :100].contiguous(), p, c, *weights)
    with pytest.raises(ValueError, match="contiguous"):
        conv_block.fused_conv_chain_rows(h.transpose(1, 2).contiguous().transpose(1, 2),
                                         p, c, *weights)


# (batch, C, T): the shapes where the JAX package packs rows (batch <= 64,
# C < 128, T % (128 // C) == 0) and the shapes next to them
@pytest.mark.parametrize("b,c,t", [
    (2, 32, 40), (64, 64, 10), (65, 32, 40), (2, 128, 40),
    (2, 32, 41), (2, 48, 40), (2, 48, 41), (2, 96, 40),
])
def test_convblock_takes_rows_entry_at_small_batch(rng, monkeypatch, b, c, t):
    """ConvBlock.forward calls the main entry once at every shape, the rows
    entry never, and gives the unfused chain's result."""
    block = fold_weight_norm(init_weights(ConvBlock(c, weight_norm=True), seed=0))
    h, nc, ic = _t(_draw(rng, b, t, c)), _t(_draw(rng, b, 2 * c)), _t(_draw(rng, b, t, c))
    calls = []
    for name in ("fused_conv_chain", "fused_conv_chain_rows"):
        real = getattr(conv_block, name)
        monkeypatch.setattr(conv_block, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    with torch.no_grad():
        got = block(h, noise_cond=nc, input_cond=ic)
        kernels.enable(False)
        try:
            want = block(h, noise_cond=nc, input_cond=ic)
        finally:
            kernels.enable(True)
    assert calls == ["fused_conv_chain"]
    for g, w in zip(got, want):
        assert g.shape == (b, t, c)
        _close(g, w.numpy(), TOL)
