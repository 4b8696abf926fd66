"""The fused ConvBlock kernel module of the PyTorch port on the CPU: the
kernel's plain version against the JAX package's Pallas kernel (run in
interpret mode) and against JAX's unfused ConvBlock, and the wrapper's and
the ConvBlock's dispatch.  Bounds: 2e-5 at float32; 3e-2 max|ref| at bf16,
where the two sides round at the same points but may sum in another order.

The CUDA kernel itself builds and runs only on the card; ``chip_smoke.py``
holds it against the plain version there.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from open_universe_tpu.nn.blocks import ConvBlock as JaxConvBlock  # noqa: E402
from open_universe_tpu.ops import pallas as pallas_config  # noqa: E402
from open_universe_tpu.ops.pallas.conv_block import (  # noqa: E402
    fused_conv_chain as jax_fused,
    fused_conv_chain_rows as jax_fused_rows,
)
from open_universe_tpu_torch.nn.blocks import ConvBlock  # noqa: E402
from open_universe_tpu_torch.ops import kernels  # noqa: E402
from open_universe_tpu_torch.ops.kernels import conv_block  # noqa: E402
from open_universe_tpu_torch.utils.convert import from_jax_params  # noqa: E402

TOL = 2e-5


@pytest.fixture
def interpret_mode():
    saved = dict(pallas_config._STATE)
    pallas_config.enable(True, interpret=True)
    yield
    pallas_config._STATE.clear()
    pallas_config._STATE.update(saved)


def _weights(rng, c):
    """Folded chain weights in the JAX layout (K, Cin, Cout)."""
    def w(k):
        return (rng.uniform(-1, 1, (k, c, c)) / np.sqrt(k * c)).astype(np.float32)

    def b():
        return rng.uniform(-0.5, 0.5, (c,)).astype(np.float32)

    def a():
        return rng.uniform(0.0, 0.5, (1,)).astype(np.float32)

    return (w(5), b(), a(), w(3), b(), a(), w(3), b(), a())


def _inputs(rng, b, t, c, with_film, with_cond):
    h = rng.standard_normal((b, t, c)).astype(np.float32)
    nc = rng.standard_normal((b, 2 * c)).astype(np.float32) if with_film else None
    ic = rng.standard_normal((b, t, c)).astype(np.float32) if with_cond else None
    return h, nc, ic


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _plain(h, weights, nc, ic):
    return conv_block.fused_conv_chain_reference(
        _t(h), *map(_t, weights), noise_cond=_t(nc), input_cond=_t(ic))


def _close(port, ref, record_property=None):
    for name, a, b in zip(("v", "cond_out"), port, ref):
        if record_property is not None:
            record_property(f"max_abs_diff_{name}",
                            float(np.abs(a.numpy() - np.asarray(b)).max()))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0)


# the JAX kernel tests' cases: FiLM and cond on and off, several tiles
# (tile_target=64 rows), lane packing P = 16, 4 and 1; and the 24 kHz
# preset's C = 48 (P = 2, 96 lanes) and C = 96 (P = 1)
@pytest.mark.parametrize("c,t,with_film,with_cond", [
    (8, 2048, False, False),
    (8, 2048, True, True),
    (32, 1280, True, False),
    (128, 512, True, True),
    (48, 256, True, True),
    (96, 136, True, False),
])
def test_plain_version_matches_pallas_kernel(rng, interpret_mode, record_property, c,
                                             t, with_film, with_cond):
    weights = _weights(rng, c)
    h, nc, ic = _inputs(rng, 2, t, c, with_film, with_cond)
    ref = jax.jit(lambda h, w, nc, ic: jax_fused(h, *w, noise_cond=nc, input_cond=ic,
                                                 tile_target=64))(h, weights, nc, ic)
    assert ref is not None
    _close(_plain(h, weights, nc, ic), ref, record_property)


@pytest.mark.parametrize("c,t,with_film,with_cond", [
    (32, 1280, True, True),
    (128, 512, True, False),
])
def test_plain_version_matches_pallas_kernel_bf16(rng, interpret_mode, record_property,
                                                  c, t, with_film, with_cond):
    """bf16 activations, weights and biases; float32 slopes, as the Pallas
    kernel takes them."""
    weights = _weights(rng, c)
    h, nc, ic = _inputs(rng, 2, t, c, with_film, with_cond)
    bf16 = [None if x is None else _t(x).to(torch.bfloat16) for x in (h, nc, ic)]
    port_w = [_t(w) if i % 3 == 2 else _t(w).to(torch.bfloat16)
              for i, w in enumerate(weights)]
    def j16(x):
        return None if x is None else _j(x).astype(jnp.bfloat16)

    ref = jax.jit(lambda h, w, nc, ic: jax_fused(h, *w, noise_cond=nc, input_cond=ic,
                                                 tile_target=64))(
        j16(h), weights, j16(nc), j16(ic))
    assert ref is not None
    port = conv_block.fused_conv_chain_reference(
        bf16[0], *port_w, noise_cond=bf16[1], input_cond=bf16[2])
    for name, a, b in zip(("v", "cond_out"), port, ref):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        diff, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        record_property(f"max_abs_diff_{name}", diff)
        assert diff <= 3e-2 * scale, (name, diff, scale)


@pytest.mark.parametrize("c,t", [(32, 1000), (128, 200)])  # a partial tail tile
def test_plain_version_matches_pallas_rows_entry(rng, interpret_mode, record_property,
                                                 c, t):
    p = max(1, 128 // c)
    weights = _weights(rng, c)
    h, nc, ic = _inputs(rng, 2, t, c, True, True)
    b = h.shape[0]
    v, cond_out = jax.jit(lambda h, w, nc, ic: jax_fused_rows(
        h, p, c, *w, noise_cond=nc, input_cond_rows=ic, tile_target=64))(
        h.reshape(b, t // p, p * c), weights, nc, ic.reshape(b, t // p, p * c))
    _close(_plain(h, weights, nc, ic), (np.asarray(v).reshape(b, t, c),
                                        np.asarray(cond_out).reshape(b, t, c)),
           record_property)


@pytest.mark.parametrize("c,t", [(32, 1001), (8, 201)])
def test_plain_version_matches_unfused_chain_where_pallas_refuses(rng, record_property,
                                                                  c, t):
    """t % (128 // c) != 0: JAX's kernel returns None, the port's never does."""
    weights = _weights(rng, c)
    h, nc, ic = _inputs(rng, 2, t, c, True, True)
    assert jax_fused(_j(h), *map(_j, weights)) is None
    block = JaxConvBlock(c)
    names = ("conv1", "conv2", "conv3")
    params = {n: {"conv": {"weight": weights[3 * i], "bias": weights[3 * i + 1]},
                  "prelu": {"weight": weights[3 * i + 2]}}
              for i, n in enumerate(names)}
    saved = dict(pallas_config._STATE)
    pallas_config.enable(False)
    try:
        v, _, cond_out = block(params, _j(h), noise_cond=_j(nc), input_cond=_j(ic))
    finally:
        pallas_config._STATE.update(saved)
    _close(_plain(h, weights, nc, ic), (v, cond_out), record_property)


def test_wrapper_takes_plain_version_only_on_cpu(rng):
    weights = _weights(rng, 16)
    h, nc, ic = _inputs(rng, 1, 40, 16, True, False)
    launches = dict(conv_block.launches)
    out = conv_block.fused_conv_chain(_t(h), *map(_t, weights), noise_cond=_t(nc))
    _close(out, _plain(h, weights, nc, None))
    assert conv_block.launches == launches  # the plain version is no launch
    with pytest.raises(ValueError, match="cpu or cuda"):
        conv_block.fused_conv_chain(_t(h).to("meta"),
                                    *(_t(w).to("meta") for w in weights))


@pytest.mark.parametrize("c", (16, 32, 40, 48, 64, 96, 128, 192, 256, 384, 512, 768))
def test_wrapper_checks_what_the_kernel_takes(rng, c):
    """The checks a CUDA call passes before launching, run on CPU tensors:
    slopes in float32 whatever h's dtype, the rest in h's dtype, h and the
    weights 16-byte aligned, and C one of the ten widths of the UNIVERSE++
    16 and 24 kHz presets, in both dtypes."""
    weights = [torch.from_numpy(w) for w in _weights(rng, c)]
    bf16 = tuple(w if i % 3 == 2 else w.to(torch.bfloat16) for i, w in enumerate(weights))
    for dtype, ws in ((torch.float32, tuple(weights)), (torch.bfloat16, bf16)):
        h = torch.zeros(1, 9, c, dtype=dtype)
        if c not in conv_block.WIDTHS:
            with pytest.raises(ValueError, match=f"C={c}"):
                conv_block._check(h, ws, None, None)
            continue
        conv_block._check(h, ws, None, None)
        conv_block._check(h, ws, torch.zeros(1, 2 * c, dtype=dtype), torch.zeros_like(h))
        with pytest.raises(ValueError, match="h must be 16-byte aligned"):
            conv_block._check(torch.zeros(9 * c + 1, dtype=dtype)[1:].view(1, 9, c), ws,
                              None, None)
    if c == 32:
        with pytest.raises(TypeError, match="a1"):
            conv_block._check(h, tuple(w.to(torch.bfloat16) for w in weights), None, None)
        with pytest.raises(TypeError, match="w5"):
            conv_block._check(h, tuple(weights), None, None)


def test_each_dtype_builds_its_own_kernel_and_nothing_falls_back(monkeypatch, tmp_path):
    """bf16 asks for the tensor-core source and f32 for the CUDA-core one; a
    build that cannot run raises with the missing compiler's name, and the
    other route is not tried."""
    from open_universe_tpu_torch.ops.kernels import build

    asked = []
    real_build = build.build
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "build", lambda *names: asked.append(names) or real_build(*names))
    for dtype, source in ((torch.bfloat16, "conv_block_tc"), (torch.float32, "conv_block")):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            conv_block._kernel_fn(dtype)
        assert asked.pop() == (source,) and not asked


def test_build_runs_one_compiler_per_source(monkeypatch, tmp_path):
    """``build`` starts a compiler for each source without a library; a
    failing one raises with its name and log, the others' libraries stay."""
    from open_universe_tpu_torch.ops.kernels import build

    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nfor a; do out=$prev; prev=$a; done\n'
                    'case "$prev" in *conv_block_tc.cu) echo "error in tc"; exit 3;; esac\n'
                    'for a; do [ "$o" = 1 ] && touch "$a"; [ "$a" = -o ] && o=1 || o=0; done\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "libs")
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    started = []
    real_popen = build.subprocess.Popen
    monkeypatch.setattr(build.subprocess, "Popen",
                        lambda cmd, **kw: started.append(cmd[-1]) or real_popen(cmd, **kw))
    with pytest.raises(RuntimeError, match="conv_block_tc: nvcc exit 3\nerror in tc"):
        build.build("conv_block", "conv_block_tc")
    assert [p.rsplit("/", 1)[-1] for p in started] == ["conv_block.cu", "conv_block_tc.cu"]
    assert build.library_path("conv_block").exists()
    assert not build.library_path("conv_block_tc").exists()
    assert build.build("conv_block") == [build.library_path("conv_block")]
    assert len(started) == 2  # an existing library is not built again


def test_tensor_core_weights_are_mma_fragments():
    """The bf16 kernel's weight copy: lane 4g + q of the 16-byte fragment of
    (tap, 16-row block kb, 16-column block nb) holds mma.m16n8k16's B values
    (k = 2q + e and 2q + 8 + e, n = g) of the n8 tiles 2nb and 2nb + 1; it is
    made once per weight tensor and anew when the tensor is written."""
    w = torch.randn(3, 48, 96).to(torch.bfloat16)
    frag = conv_block.mma_weights_layout(w)
    assert frag.shape == (3, 3, 6, 32, 8) and frag.is_contiguous()
    lane = torch.arange(32)
    g, q = lane // 4, lane % 4
    for kb, nb in ((0, 0), (2, 5), (1, 3)):
        for pos in range(8):
            h8, kh, e = pos // 4, (pos // 2) % 2, pos % 2
            want = w[:, 16 * kb + 8 * kh + 2 * q + e, 16 * nb + 8 * h8 + g]
            assert torch.equal(frag[:, kb, nb, :, pos], want)
    cached = conv_block.mma_weights(w)
    assert conv_block.mma_weights(w) is cached
    assert conv_block.mma_weights(w.clone()) is not cached
    with torch.no_grad():
        w.mul_(2)
    again = conv_block.mma_weights(w)
    assert again is not cached and torch.equal(again, conv_block.mma_weights_layout(w))
    with torch.inference_mode():
        frozen = w.clone()
        assert torch.equal(conv_block.mma_weights(frozen), again)


def test_convblock_kernel_weights_follow_the_parameters():
    """The kernel-layout weights are made once per dtype and made anew when a
    parameter is written; bf16 slopes are float32 values rounded through bf16."""
    block = ConvBlock(32)
    for m in block.modules():
        if hasattr(m, "fold_weight_norm"):
            m.fold_weight_norm()
    with torch.no_grad():
        block.conv2.prelu.weight.fill_(0.3)
    args = block._chain_args(torch.float32)
    assert block._chain_args(torch.float32) is args
    w5 = block.conv1.conv.weight
    np.testing.assert_array_equal(args[0].numpy(), w5.detach().permute(2, 1, 0).numpy())
    low = block._chain_args(torch.bfloat16)
    assert [a.dtype for a in low[2::3]] == [torch.float32] * 3
    assert low[5].item() == torch.tensor(0.3).to(torch.bfloat16).float().item()
    assert low[0].dtype == torch.bfloat16
    with torch.no_grad():
        w5.mul_(2.0)
    again = block._chain_args(torch.float32)
    assert again is not args
    np.testing.assert_array_equal(again[0].numpy(), 2.0 * args[0].numpy())


def test_convblock_dispatch(rng, monkeypatch):
    """Folded weights under no_grad or inference_scope take the fused path at
    any width and length; training, weight norm or enable(False) take the
    unfused chain, with the same result."""
    calls = []
    real = conv_block.fused_conv_chain

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(conv_block, "fused_conv_chain", spy)
    c = 16
    block = ConvBlock(c, weight_norm=True)
    jax_block = JaxConvBlock(c, weight_norm=True)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax_block.init)(jax.random.key(0)))
    from_jax_params(block, params)
    h, nc, _ = _inputs(rng, 2, 37, c, True, False)
    with torch.no_grad():
        unfolded = block(_t(h), noise_cond=_t(nc))
        assert not calls  # weight norm not folded
        for m in block.modules():
            if hasattr(m, "fold_weight_norm"):
                m.fold_weight_norm()
        fused = block(_t(h), noise_cond=_t(nc))
        assert calls == [(2, 37, c)]
        kernels.enable(False)
        try:
            unfused = block(_t(h), noise_cond=_t(nc))
        finally:
            kernels.enable(True)
    assert len(calls) == 1
    grad_on = block(_t(h), noise_cond=_t(nc))  # autograd on: no fused path
    assert len(calls) == 1
    with kernels.inference_scope():
        block(_t(h), noise_cond=_t(nc))
    assert len(calls) == 2
    for a, b, d in zip(fused, unfused, unfolded):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0)
        np.testing.assert_allclose(a.numpy(), d.numpy(), atol=TOL, rtol=0)
    assert grad_on[0].requires_grad
