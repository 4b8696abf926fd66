"""The fused ConvBlock kernel module of the PyTorch port on the CPU: the
kernel's plain version against the JAX package's Pallas kernel (run in
interpret mode) and against JAX's unfused ConvBlock, and the wrapper's and
the ConvBlock's dispatch.  Bounds: 2e-5 at float32; 3e-2 max|ref| at bf16,
where the two sides round at the same points but may sum in another order.

The CUDA kernel itself builds and runs only on the card: the tests marked
``card`` hold both routes against the plain version there, the f32 route on
each of its cores (``python -m pytest --noconftest -m card
tests/test_torch_conv_block.py``; that machine has no JAX, which only the
CPU tests need).  Here the f32 route's numerics (3xTF32) are held by an
emulation of its split products.
"""
import contextlib
import math
import re

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from open_universe_tpu.nn.blocks import ConvBlock as JaxConvBlock
    from open_universe_tpu.ops import pallas as pallas_config
    from open_universe_tpu.ops.pallas.conv_block import (
        fused_conv_chain as jax_fused,
        fused_conv_chain_rows as jax_fused_rows,
    )
except ImportError:  # the card's machine: the card tests need no JAX
    jax = None
from open_universe_tpu_torch.nn.blocks import ConvBlock  # noqa: E402
from open_universe_tpu_torch.ops import kernels  # noqa: E402
from open_universe_tpu_torch.ops.kernels import conv_block, tile_probe  # noqa: E402
from open_universe_tpu_torch.utils.convert import from_jax_params  # noqa: E402

TOL = 2e-5
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}  # of max|plain|, on the card
needs_jax = pytest.mark.skipif(jax is None, reason="holds the port against the JAX package")


@pytest.fixture(scope="module", autouse=True)
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
@needs_jax
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


@needs_jax
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


@needs_jax
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


@needs_jax
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
    """Both dtypes ask for the one tensor-core source, each for its own C
    entry (bf16 and 3xTF32); a build that cannot run raises with the missing
    compiler's name, and no other source is tried."""
    from open_universe_tpu_torch.ops.kernels import build

    asked = []
    real_build = build.build
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "build", lambda *names: asked.append(names) or real_build(*names))
    assert {route[1] for route in conv_block.ROUTES.values()} == {"conv_block_tc"}
    assert len({route[2] for route in conv_block.ROUTES.values()}) == 2
    assert conv_block.ROUTES[torch.float32][0] == "f32_tensor_cores_3xtf32"
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            conv_block._kernel_fn(dtype)
        assert asked.pop() == ("conv_block_tc",) and not asked
    assert sorted(p.name for p in build.CSRC_DIR.glob("*.cu")) == [
        "conv_block_tc.cu", "rate_change_tc.cu"]  # the chain's, the rate change's


def test_build_runs_one_compiler_per_source(monkeypatch, tmp_path):
    """``build`` starts a compiler for each source without a library; a
    failing one raises with its name and log, the others' libraries stay."""
    from open_universe_tpu_torch.ops.kernels import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("first", "second"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nfor a; do out=$prev; prev=$a; done\n'
                    'case "$prev" in *second.cu) echo "error in second"; exit 3;; esac\n'
                    'for a; do [ "$o" = 1 ] && touch "$a"; [ "$a" = -o ] && o=1 || o=0; done\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "libs")
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    started = []
    real_popen = build.subprocess.Popen
    monkeypatch.setattr(build.subprocess, "Popen",
                        lambda cmd, **kw: started.append(cmd[-1]) or real_popen(cmd, **kw))
    with pytest.raises(RuntimeError, match="second: nvcc exit 3\nerror in second"):
        build.build("first", "second")
    assert [p.rsplit("/", 1)[-1] for p in started] == ["first.cu", "second.cu"]
    assert build.library_path("first").exists()
    assert not build.library_path("second").exists()
    assert build.build("first") == [build.library_path("first")]
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


def test_tf32_weights_are_split_mma_fragments():
    """The f32 kernel's weight copy: each value split into TF32 hi (13 low
    mantissa bits zero, rounded to nearest with ties away from zero, as
    cvt.rna.tf32.f32 rounds) and lo = tf32(w - hi), |hi + lo - w| <= 2^-21
    |w|; lane 4g + q of the 16-byte fragment of (tap, 8-row block kb, n8
    tile nb) holds hi, hi, lo, lo of mma.m16n8k8's B values (k = q, q + 4;
    n = g); made once per weight tensor and anew when it is written."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(3, 16, 24, generator=g) * torch.logspace(-4, 4, 24)
    hi, lo = conv_block.tf32_split(w)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros_like(w, dtype=torch.int32))
    assert torch.equal(lo.view(torch.int32) & 0x1FFF, torch.zeros_like(w, dtype=torch.int32))
    assert ((hi + lo - w).abs() <= 2.0 ** -21 * w.abs()).all()
    assert torch.equal(hi.view(torch.int32), (w.view(torch.int32) + 0x1000) & -0x2000)
    # nearest: within half a TF32 ulp; ties go away from zero
    ulp = torch.exp2(torch.floor(torch.log2(w.double().abs())) - 10)
    assert ((hi.double() - w.double()).abs() <= ulp / 2).all()
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23, 3 * 2 ** -12])
    assert conv_block.tf32_round(ties).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0,
                                                   3 * 2 ** -12]

    frag = conv_block.mma_weights_tf32_layout(w)
    assert frag.shape == (3, 2, 3, 32, 4) and frag.is_contiguous()
    lane = torch.arange(32)
    gg, q = lane // 4, lane % 4
    for kb, nb in ((0, 0), (1, 2), (0, 1)):
        for pos in range(4):
            part, kh = divmod(pos, 2)
            want = (hi, lo)[part][:, 8 * kb + 4 * kh + q, 8 * nb + gg]
            assert torch.equal(frag[:, kb, nb, :, pos], want)
    cached = conv_block.mma_weights(w)
    assert torch.equal(cached, frag) and conv_block.mma_weights(w) is cached
    with torch.no_grad():
        w.mul_(2)
    again = conv_block.mma_weights(w)
    assert again is not cached and torch.equal(again, 2 * frag)


def test_tf32_weights_are_wgmma_stage_tiles():
    """The f32 wgmma core's weight stream: for tap k and 8-row block kb of
    Cin (one k8 step, one ring stage of 64 Cout bytes, contiguous in tap
    then kb order), part 0 holds the TF32 hi and part 1 the lo of
    w[k, 8kb + 4kh + kk, 8j + r] at (j, kh, r, kk): core matrices of 8
    output x 4 input channels of 16-byte rows, the next 4 input channels 128
    bytes on, the next 8 output channels 256 bytes on.  Cached beside the
    mma.sync core's layout of the same tensor, each made anew when it is
    written."""
    g = torch.Generator().manual_seed(1)
    w = torch.randn(5, 16, 24, generator=g) * torch.logspace(-3, 3, 24)
    hi, lo = conv_block.tf32_split(w)
    tiles = conv_block.wgmma_weights_tf32_layout(w)
    assert tiles.shape == (5, 2, 2, 3, 2, 8, 4) and tiles.is_contiguous()
    for k, kb, part, j, kh, r, kk in ((0, 0, 0, 0, 0, 0, 0), (4, 1, 1, 2, 1, 7, 3),
                                      (2, 0, 1, 1, 0, 3, 2), (3, 1, 0, 2, 1, 5, 1)):
        want = (hi, lo)[part][k, 8 * kb + 4 * kh + kk, 8 * j + r]
        assert torch.equal(tiles[k, kb, part, j, kh, r, kk], want)
    # byte offsets of the stage: LBO 128 (kh), SBO 256 (j), 64 Cout per step
    flat = tiles.reshape(-1)
    step = 64 * 24 // 4
    assert torch.equal(flat[step * (3 * 2 + 1):][:32 * 24 // 4 * 2].reshape(2, 3, 2, 8, 4),
                       tiles[3, 1])
    assert torch.equal(flat[step * 5 + 256 // 4 * 2 + 128 // 4 + 4 * 5:][:4],
                       hi[2, 8 * 1 + 4 + torch.arange(4), 8 * 2 + 5])
    both = [conv_block.mma_weights(w, layout) for layout in
            (conv_block.wgmma_weights_tf32_layout, conv_block.mma_weights_tf32_layout)]
    assert torch.equal(both[0], tiles)
    assert torch.equal(both[1], conv_block.mma_weights_tf32_layout(w))
    assert conv_block.mma_weights(w, conv_block.wgmma_weights_tf32_layout) is both[0]
    assert conv_block.mma_weights(w) is both[1]  # float32's default: mma.sync's
    with torch.no_grad():
        w.mul_(2)
    again = conv_block.mma_weights(w, conv_block.wgmma_weights_tf32_layout)
    assert again is not both[0] and torch.equal(again, 2 * tiles)


def _tf32x3_chain(h, w5, b5, a1, w3a, b3a, a2, w3b, b3b, a3, noise_cond, input_cond):
    """The f32 chain with every conv product split as the 3xTF32 kernel
    splits it: weights into TF32 hi + lo (``tf32_split``), activations into
    hi = tf32(x) and lo = x - hi cut to TF32 as the tensor core reads it
    (its 13 low bits dropped), and a_lo b_hi + a_hi b_lo + a_hi b_hi summed
    in float32 (each TF32 product is exact in float32).  A test of the
    design's numerics, on no path."""
    import torch.nn.functional as F

    def conv(x, w, bias):
        xh = conv_block.tf32_round(x)
        xl = ((x - xh).view(torch.int32) & -0x2000).view(torch.float32)
        wh, wl = conv_block.tf32_split(w)

        def one(a, b):
            return F.conv1d(a.transpose(1, 2), b.permute(2, 1, 0),
                            padding=b.shape[0] // 2).transpose(1, 2)

        return one(xl, wh) + one(xh, wl) + one(xh, wh) + bias

    def prelu(x, a):
        return torch.where(x >= 0, x, a * x)

    n = h.shape[-1]
    cond_out = conv(prelu(h, a1), w5, b5)
    c = (cond_out + input_cond) * conv_block.SQRT_HALF
    c = noise_cond[:, None, :n] * c + noise_cond[:, None, n:]
    c = prelu(conv(prelu(c, a2), w3a, b3a), a3)
    return (h + conv(c, w3b, b3b)) * conv_block.SQRT_HALF, cond_out


@pytest.mark.parametrize("c", [768, 32])
def test_3xtf32_split_holds_the_f32_gate(rng, record_property, c):
    """The 3xTF32 design on the CPU, before the card: the chain with every
    product split as the kernel splits it stays within the card's f32 gate
    (1e-4 max|ref|) of the plain version, at the widest and narrowest
    width, FiLM and cond on."""
    weights = _weights(rng, c)
    h, nc, ic = _inputs(rng, 1, 40, c, True, True)
    ref = _plain(h, weights, nc, ic)
    got = _tf32x3_chain(_t(h), *map(_t, weights), _t(nc), _t(ic))
    for name, a, r in zip(("v", "cond_out"), got, ref):
        diff, scale = (a - r).abs().max().item(), r.abs().max().item()
        record_property(f"max_abs_diff_{name}", diff)
        assert diff <= 1e-4 * scale, (name, diff, scale)


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


@needs_jax
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
        block(_t(h), noise_cond=_t(nc))  # the parameters need gradients
        assert len(calls) == 1
        for p in block.parameters():
            p.requires_grad_(False)
        block(_t(h), noise_cond=_t(nc))
    assert len(calls) == 2
    for a, b, d in zip(fused, unfused, unfolded):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0)
        np.testing.assert_allclose(a.numpy(), d.numpy(), atol=TOL, rtol=0)
    assert grad_on[0].requires_grad


def test_f32_cores_follow_the_table(monkeypatch):
    """The f32 route's cores come from the source's WgTile: a width without
    an entry has only mma_sync, one with MIN_ROWS = 0 only wgmma, the others
    both, wgmma from MIN_ROWS rows up; the source has a Tile<F32, C> (the
    mma.sync core) exactly at the widths that can take it, and bf16 runs
    mma_sync everywhere."""
    src = (tile_probe.build.CSRC_DIR / "conv_block_tc.cu").read_text()
    least = {int(c): int(m) for c, m in re.findall(
        r"struct WgTile<(\d+)> \{[^}]*MIN_ROWS = (\d+);", src)}
    f32_tiles = {int(c) for c in re.findall(r"struct Tile<F32, (\d+)>", src)}
    bf16_tiles = {int(c) for c in re.findall(r"struct Tile<Bf16, (\d+)>", src)}
    assert bf16_tiles == set(conv_block.WIDTHS)
    assert f32_tiles == {c for c in conv_block.WIDTHS if least.get(c, -1) != 0}
    assert set(least) < set(conv_block.WIDTHS) and 768 not in least
    monkeypatch.setattr(conv_block, "_wgmma_min_rows", lambda c, lib=None: least.get(c, -1))
    for c in conv_block.WIDTHS:
        cores = conv_block.width_cores(torch.float32, c)
        assert cores == {-1: ("mma_sync",), 0: ("wgmma",)}.get(least.get(c, -1),
                                                                 conv_block.CORES)
        assert conv_block.width_cores(torch.bfloat16, c) == ("mma_sync",)
        for rows in (1, 2 * 32160, 128 * 201, 128 * 32160):
            core = conv_block.chain_core(torch.float32, rows, c)
            assert core in cores
            assert (core == "wgmma") == (c in least and rows >= least[c])
            assert conv_block.chain_core(torch.bfloat16, rows, c) == "mma_sync"


def test_tile_probe_writes_both_tables():
    """``tile_probe`` writes a table's entries into a copy of the source: a
    Tile<P, C> entry (mma.sync) and a WgTile<C> entry (wgmma) each replace
    the one line of their width and nothing else; a width the source has no
    entry for is refused."""
    src = (tile_probe.build.CSRC_DIR / "conv_block_tc.cu").read_text()
    table = {("F32", 128): (32, 8, 2), ("WgTile", 128): (64, 2, 64, 1, 6, 1, 4096)}
    out = tile_probe.table_source(table)
    assert ("template <> struct Tile<F32, 128> { static constexpr int BM = 32, WN = 8, "
            "BLOCKS = 2; };") in out
    assert ("template <> struct WgTile<128> { static constexpr int BM = 64, NW = 2, WI = 64, "
            "KS = 1, STAGES = 6, BLOCKS = 1, MIN_ROWS = 4096; };") in out
    changed = [a for a, b in zip(src.splitlines(), out.splitlines()) if a != b]
    assert len(src.splitlines()) == len(out.splitlines()) and len(changed) == 2
    for name, t in tile_probe.TABLES.items():
        tile_probe.table_source(t)  # every probe table names entries the source has
    with pytest.raises(ValueError, match="WgTile<768>"):
        tile_probe.table_source({("WgTile", 768): (64, 1, 128, 1, 2, 1, 0)})


# ---- on the card -----------------------------------------------------------

# the widths where the f32 route takes the wgmma core at the benchmark's
# batch-128 shapes; C = 512 and 768 keep mma.sync there
WGMMA_WIDTHS = (32, 48, 64, 96, 128, 192, 256, 384)
BOTH_CORES = (32, 128, 256)  # the f32 widths that have both cores
MAIN_T = {32: 32160, 48: 48240, 64: 16080, 96: 24120, 128: 4020, 192: 8040, 256: 1005,
          384: 1608, 512: 201, 768: 201}  # a 2 s clip at each width, 16 or 24 kHz


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    allow = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in float32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = allow


def _card_inputs(b, t, c, dtype, film, cond, seed):
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=1.0):
        return ((torch.rand(shape, generator=g) * 2 - 1) * scale).to("cuda", dtype)

    weights = []
    for k in (5, 3, 3):
        weights += [rand(k, c, c, scale=1 / math.sqrt(k * c)), rand(c, scale=0.5),
                    (torch.rand(1, generator=g) * 0.5).cuda()]
    return (rand(b, t, c), weights, rand(b, 2 * c) if film else None,
            rand(b, t, c) if cond else None)


def _card_case(entry, c, b, t, dtype, film, cond, core=None):
    """One launch of ``entry`` against the plain version within the dtype's
    card bound; the (core, C) it counted."""
    p = max(1, 128 // c)
    h, weights, nc, ic = _card_inputs(b, t, c, dtype, film, cond, seed=c + t + b)
    conv_block.launches.clear()
    conv_block.core_launches.clear()
    if entry == "rows":
        def pk(x):
            return None if x is None else x.reshape(b, t // p, p * c)

        if core:
            got = conv_block._launch("fused_conv_chain_rows", h, weights, nc, ic, core=core)
            got = tuple(pk(x) for x in got)
        else:
            got = conv_block.fused_conv_chain_rows(pk(h), p, c, *weights, noise_cond=nc,
                                                   input_cond_rows=pk(ic))
        torch.cuda.synchronize()
        ref = conv_block.fused_conv_chain_rows_reference(pk(h), p, c, *weights, noise_cond=nc,
                                                         input_cond_rows=pk(ic))
    else:
        got = conv_block._launch("fused_conv_chain", h, weights, nc, ic, core=core) if core \
            else conv_block.fused_conv_chain(h, *weights, noise_cond=nc, input_cond=ic)
        torch.cuda.synchronize()
        ref = conv_block.fused_conv_chain_reference(h, *weights, noise_cond=nc, input_cond=ic)
    for name, a, r in zip(("v", "cond_out"), got, ref):
        assert a.shape == r.shape and a.dtype == dtype and a.is_contiguous()
        diff, scale = (a.float() - r.float()).abs().max().item(), r.float().abs().max().item()
        assert math.isfinite(diff) and diff <= CARD_TOL[dtype] * scale, (name, diff, scale)
    full = {"rows": "fused_conv_chain_rows"}.get(entry, entry)
    assert dict(conv_block.launches) == {
        (full, conv_block.ROUTES[dtype][0], c, t, film, cond): 1}
    (counted, n), = conv_block.core_launches.items()
    assert n == 1 and counted[1] == c
    return counted


# (entry, batch, T, FiLM, cond): T = 1 and 201, 1004 (no tile divides it),
# the 2 s length ("main"); the rows entry at T = P (one row); batch 1 and 128
CARD_SHAPES = [("fused_conv_chain", 1, 1, True, True),
               ("fused_conv_chain", 128, 201, False, False),
               ("fused_conv_chain", 1, 1004, True, False),
               ("fused_conv_chain", 1, "main", False, True),
               ("fused_conv_chain", 128, "main", True, True),
               ("rows", 1, "P", True, True),
               ("rows", 128, 1004, False, True),
               ("rows", 1, "main", True, False),
               ("rows", 16, "main", False, False)]


@pytest.mark.card
@pytest.mark.parametrize("entry,b,t,film,cond", CARD_SHAPES)
@pytest.mark.parametrize("c", conv_block.WIDTHS)
def test_f32_route_holds_the_gate_on_card(card, c, entry, b, t, film, cond):
    """The f32 route on the core the table gives each shape, within the f32
    gate (1e-4 max|plain|) of the plain version, at every width, both
    entries, batch 1 and 128; the batch-128 2 s shapes run wgmma at
    C = 32..384 and mma.sync at C = 512 and 768."""
    t = {"main": MAIN_T[c], "P": max(1, 128 // c)}.get(t, t)
    core = _card_case(entry, c, b, t, torch.float32, film, cond)
    assert core[0] == conv_block.chain_core(torch.float32, b * t, c)
    if (b, t) == (128, MAIN_T[c]):
        assert core[0] == ("wgmma" if c in WGMMA_WIDTHS else "mma_sync")


@pytest.mark.card
@pytest.mark.parametrize("core", conv_block.CORES)
@pytest.mark.parametrize("c", BOTH_CORES)
def test_each_f32_core_holds_the_gate_on_card(card, c, core):
    """Either f32 core forced at every width that has both, batch 2 with a
    partial last tile and at the 2 s length, FiLM and cond on: within the
    f32 gate, counted under that core."""
    assert conv_block.width_cores(torch.float32, c) == conv_block.CORES
    for t in (1004, MAIN_T[c]):
        assert _card_case("fused_conv_chain", c, 2, t, torch.float32, True, True,
                          core=core) == (core, c)


@pytest.mark.card
@pytest.mark.parametrize("c", sorted(set(conv_block.WIDTHS) - set(BOTH_CORES)))
def test_f32_widths_with_one_core_refuse_the_other_on_card(card, c):
    """C = 48, 64, 96, 192 and 384 have only the wgmma core, 512 and 768
    only mma_sync: forcing the other raises before any launch is counted."""
    cores = conv_block.width_cores(torch.float32, c)
    assert cores == (("wgmma",) if c in WGMMA_WIDTHS else ("mma_sync",))
    (other,) = set(conv_block.CORES) - set(cores)
    h, weights, nc, ic = _card_inputs(2, 9, c, torch.float32, False, False, seed=0)
    conv_block.launches.clear()
    conv_block.core_launches.clear()
    with pytest.raises(RuntimeError, match=f"no {other} core at C={c}"):
        conv_block._launch("fused_conv_chain", h, weights, nc, ic, core=other)
    assert not conv_block.launches and not conv_block.core_launches


@pytest.mark.card
@pytest.mark.parametrize("c", conv_block.WIDTHS)
def test_bf16_route_keeps_mma_sync_on_card(card, c):
    """The bf16 route runs the mma.sync core at every width and shape (its
    kernel instance and table are the ones it had before the f32 route took
    wgmma, untouched by construction), within its bound of the plain
    version; wgmma is refused for it."""
    for b, t in ((1, 1), (2, 1004), (128, 201)):
        assert _card_case("fused_conv_chain", c, b, t, torch.bfloat16, True, True) == (
            "mma_sync", c)
    h, weights, nc, ic = _card_inputs(1, 9, c, torch.bfloat16, False, False, seed=0)
    with pytest.raises(RuntimeError, match="wgmma"):
        conv_block._launch("fused_conv_chain", h, weights, nc, ic, core="wgmma")
