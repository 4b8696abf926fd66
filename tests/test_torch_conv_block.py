"""The fused ConvBlock kernel module of the PyTorch port on the CPU: the
kernel's plain version against the JAX package's Pallas kernel (run in
interpret mode) and against JAX's unfused ConvBlock, and the wrapper's and
the ConvBlock's dispatch.  Bounds: 2e-5 at float32; 3e-2 max|ref| at bf16,
where the two sides round at the same points but may sum in another order.

The CUDA kernel itself builds and runs only on the card; ``chip_smoke.py``
holds it against the plain version there.  Here the f32 route's numerics
(3xTF32) are held by an emulation of its split products.
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
    assert sorted(p.name for p in build.CSRC_DIR.glob("*.cu")) == ["conv_block_tc.cu"]


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
